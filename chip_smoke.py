"""Drive the PyTorch port's reconstruction and training paths (the
flagship, --pa_feat, --cls and --pa_feat --cls, the generic decoders,
training from an LMDB dataset with the stem pool through K7, the proof
of learning scored by the evaluation, training and testing from the
reference's per-file layout, and from an ASDF-pack and forked loader
workers, bf16 serving, bf16 training through K2, K4 and K5, a latent
input at the final layer, K4's band with cli.train --pixel_band) on one
CUDA GPU and hold each hand-written kernel against its plain PyTorch
version.

    python3 chip_smoke.py [--record PATH]

Phases (each prints its own lines; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel (K1-K7) from the sources in the
     checkout, one nvcc per source, all at once;
  3. K1 vs plain: the fused grid decoder against grid_decode_reference at
     full flagship width on a 64^3 grid, TF32 off, max abs err <= 1e-4;
  4. K2 vs plain: both train trunks at full flagship width on 4 scenes x
     2000 points and on the main path's 64 x 2000, TF32 off: y to 1e-4 abs
     against the plain forward and against the float64 forward; the
     residuals (the tensor-core forward's, csrc/train_fwd_tc.cuh) to 1e-4
     abs where both sides are positive, flips at ReLU's edge counted and
     allowed only at values within FLIP_TOL of 0; every
     gradient of the autograd Function to 1e-4 of the largest entry of the
     plain backward's on the same residuals, and of that backward run in
     float64; each dropout layer's kept
     share at 0.8 +- 0.01; the kernel's residuals gated as the plain
     forward's;
  5. reconstruction: the flagship model (experiments/obman_30k.json with
     --mano --obj_pose --encode both --point_size 9) at full width with
     seeded weights reconstructs 3 synthetic 256x256 images at cube_dim 128
     through run_pipelined; K1's launch count, finite fields, written
     meshes, and the field of image 0 against the generic decoder;
  6. the same run warm, and again under torch.profiler (device busy share,
     device time by kernel);
  7. training: the flagship at full width (64 scenes x 2000 points, 256x256
     synthetic images, seeded weights, the init guard) through
     cli/train.make_trainer: 2 warm-up and 5 timed steps on one batch; K2's
     launch counts, finite losses, the total falling, parameters moving;
     ms/step, scenes/s and the time by phase (CUDA events); then one step
     two ways (the same state and seed through K2 and through its plain
     version, deterministic algorithms on: losses to 1e-5 relative, every
     parameter's gradient to 1e-3 of its largest entry, updated parameters
     to 2e-5 abs; beside it the plain step against itself with K2's input
     scaled by 1 + 2^-23, the comparison's rounding floor) and
     2 steps under torch.profiler (K2's device time, the idle share); then
     5 more steps with cuDNN's TF32 on, timed only (PyTorch's default, not
     the mode the CLIs and this script run: float32, TF32 off);
  8. timing: K1 and its plain version per grid pass at 128^3 and 256^3
     beside both bounds (split TF32 on the tensor cores, K1's arithmetic
     since it moved there, and the CUDA cores' float32); K2 forward and
     backward per step (both trunks, 64 x 2000) against their plain
     versions and both bounds, the backward's chain kernel (csrc/chain_tc.cuh
     on the tensor cores) timed apart by the profiler beside both bounds of
     its work (the mean of the launches it recorded, times the launches a
     call), and the backward's weight-gradient reductions
     alone (csrc/wgrad_tc.cuh, through kernels/weight_grad.py on seeded
     operands of their shapes: each route's time, both bounds,
     torch.matmul(A, B.T) with TF32 off beside);
  9. pixel: the flagship with --pa_feat at full width (the per-point latent
     sampled bicubically from the 256 x 64 x 64 HeadNet map), seeded weights
     with the final biases shifted as in 5: K3 against its plain version
     over both 128^3 passes of image 0 (max abs err <= 1e-4, TF32 off; pass
     1's in-image share strictly between 0 and 1); run_pipelined over 3
     images at cube_dim 128 (K3's launch count, finite fields, hand and
     object meshes); image 0's field against the generic path
     (pixel_alignment + decoder) at 4096 grid points in both projection
     modes; a warm and a profiled run; K3 and its plain version per 128^3
     pass against the bound, and F.grid_sample at the same points as a
     yardstick of the sampling step alone;
 10. pixel training: the --pa_feat flagship at full width through K4: K4
     against its plain version at 4 x 2000 and 64 x 2000 points on the
     HeadNet map and projection of a synthetic batch (y and the residuals
     as K2's in 4, against the plain and the float64 forward, every
     gradient to 1e-4 of the largest entry of the plain backward fed the
     kernel's residuals, kept shares 0.8 +- 0.01, the in-image share
     strictly between 0 and 1); the train step through
     cli/train.make_trainer as in 7 (K4's launch counts, losses, ms/step,
     time by phase and peak memory, one step two ways with gradients to
     1e-2 of their largest entry, 2 profiled steps);
     K4 forward and backward per step against the plain versions and both
     bounds, with F.grid_sample's forward and backward at the step's points
     as yardsticks of the sampling alone, and the backward's chain and
     reductions alone as for K2;
 11. classifier: the labelled DexYCB full model (experiments/dexycb_140k.json
     with --mano --obj_pose --encode both --point_size 9 --cls) at full
     width, seeded weights with the final biases shifted as in 5 and the
     classifier head scaled x40 and centred so that the labels vary: K1 with
     2 + C rows against its plain version over one 128^3 pass at C = 6, 8
     (the TPU's points-major K1p route) and 126 (1e-4 abs on every row, the
     same argmax wherever the top two logits differ by more than 1e-5);
     run_pipelined over 3 images at cube_dim 128 with label_out and viz (K1's
     launch count, a label npz with one label in [0, 6) per hand-mesh vertex
     and a color PLY per hand mesh); image 0's fields and logits against
     decode_points at 4096 grid points; K2 with x_last / dx_last against its
     plain version at 4 x 2000 and 64 x 2000; 7 train steps with the
     cross-entropy on (AdditionalLossStart 1), one step two ways and 2
     profiled steps; K1's time per pass at C = 6 and K2's with x_last;
 12. pixel classifier: the same model with --pa_feat (--pa_feat --cls), the
     same seeded set-up, through K3 with 2 + C rows and K4 with x_last: K3
     against its plain version over the first 128^3 pass of image 0 at C = 6
     and 126 (1e-4 abs, argmax as in 11, the pass's in-image share strictly
     between 0 and 1); run_pipelined with label_out and viz over 3 images
     (12 K3 launches, a label npz per hand mesh); image 0's fields and logits
     against the generic path (pixel_alignment + decode_points) at 4096
     points; K4 with x_last / dx_last against its plain version at 4 x 2000
     and 64 x 2000 on the real map and projection; 7 train steps with the
     cross-entropy on, one step two ways, 2 profiled steps; K3's time per
     pass at C = 6 and K4's with x_last;
 13. generic serving and training (latent_in (0, 2)) through K6 (on the
     tensor-core trunk: its time per 128^3 pass beside both bounds and the
     plan's build time) and K5 (on the tensor cores, as K2 and K4: checked
     as K2 in 4, on the twin trunks and on a combined trunk; its chain and
     reductions timed alone as for K2);
 14. K7, the stem max pool 3x3 / stride 2 / pad 1, against its plain
     version on post-ReLU inputs with flat positive blocks and zero rows, at
     the train shape (64, 64, 128, 128) and serving's batch 1, in the
     channels-last layout of the encoder's stem and in NCHW, and at the odd
     shape (3, 5, 37, 29): the forward and the backward bit for bit (the
     forward also equal to F.max_pool2d's); the share of positions where
     K7's gradient differs from F.max_pool2d's (printed; the tie routing
     differs); K7's forward and backward times (channels last, train and
     serving shapes) against the bytes bound (and their share of it), the
     plain versions and F.max_pool2d's forward and backward; then serving
     with the stem pool switched to K7 (models/resnet.KERNEL_POOL): image 0
     of phase 5 encoded both ways, the
     stem pool outputs equal, the latents within 1e-6, one K7 launch;
 15. dataset training, the slice's path: 128 scenes (2 x ScenesPerBatch,
     256x256 raw RGB, the flagship's SDF rows) written as five LMDBs by
     data/synthetic.write_synthetic_lmdb into a temporary directory; with the
     switch on, cli.train.main for the flagship (TrainSplit emptied, the
     augmentation on, Resume naming the init guard's draw) for 2 epochs,
     then --continue from its directory to epoch 3: K7's forward and
     backward launches equal to the steps and K2's to two a step, finite
     losses, the LR schedule, latest.pth and the metrics JSONL, the resume
     at epoch 3; ms/step and scenes/s at epoch start-up (2 batches an
     epoch) beside the synthetic flagship's, the loader's time a batch, the
     idle share over an epoch's profiled steps; one step two ways on a
     batch with rotated black corners (K7 against the plain separable pool,
     both through K2: gradients to 1e-3 of the largest; printed beside, the
     rounding floor (the K7 step run twice: K2's atomic sums), the step with
     the pool's input scaled by 1 + 2^-23 and F.max_pool2d's step); then one
     epoch of 24 batches from a second dataset of 1536 scenes, timed past
     the loader's start-up, 4 steps profiled for the idle share;
 16. the proof of learning, then evaluation: 16 scenes of the geometric
     dataset (hand and object spheres with exact SDF rows, MANO-fitted
     joints; data/synthetic.py:write_geometric_lmdb: train LMDBs, the test
     split's meta and GT meshes, a samples npz) in a temporary directory;
     the flagship at full width (ScenesPerBatch 16, so a batch is an epoch;
     AdditionalLossStart 1001; no augmentation; the init guard) trained
     1,400 steps through cli/train.make_trainer's step (K2: two launches
     each way a step), the supervision re-drawn from the LMDBs every 25
     steps; hand_sdf below 0.35 and obj_sdf below 0.5 of their first
     values, the joint loss falling; K2 against its plain version (and
     float64) on the last batch's latents and point embeddings through the
     trained model, 16 x 2000 points; then through cli.reconstruct.main (K1:
     two passes an image in runs of 2^20 points) and cli.evaluate.main: the
     untrained model's MANO joints (32^3), the 16 scenes at 128^3 (hand,
     --obj and --mano), 4 scenes at 128^3 with --eval_mode and 4 at 256^3
     (hand and --obj), each run's chamfers, errors and per-image timings
     (grid, marching cubes, largest component, ICP, export, host in all);
     no failure, hand chamfer <= 2.0 cm^2 and object <= 2.5 at 128^3, MANO
     joint error below the untrained model's; the 16 scenes again as a
     test split of JPEG files (the geometric writer's test/rgb and split
     json) through cli.reconstruct -s --data_root at 128^3 and
     cli.evaluate (hand and --obj): the split's patches equal to the
     samples npz's images (the writer stores each image as its JPEG
     decodes), chamfers printed beside the --samples run's, the same
     bounds, the host time to read an item (JPEG decode and centre crop);
     the 16 scenes served with --bf16 and ComputeDtype bfloat16 at 128^3
     (K1 in bf16) and scored to the same bounds, beside the float32 run's
     chamfers; K1 against its plain version on the trained weights'
     256^3 plan (its first and last runs of 2^20 points; K1 in bf16 on
     the first), then its time per 256^3 pass; then (phase 20's) the same
     1,400 steps from the same init in bf16 (ComputeDtype bfloat16: K2's
     bf16 launches two a step each way, none of float32's), served with
     --bf16 at 128^3 and scored to the same bounds (hand, --obj, --mano:
     MANO joints below the untrained model's);
 17. the per-file layout: 128 scenes (2 x ScenesPerBatch) and a 4-image test
     split written as JPEG, npz and pkl files by
     data/synthetic.write_synthetic_dataset; the flagship JSON with LMDB
     false and a TrainSplit json through cli.train.main --data_root for one
     epoch (2 steps, the stem pool through K7, Resume naming the init
     guard's draw), then its default post-training test of the split at
     128^3: K7's backward launches equal to the steps and its forward's to
     the steps and the test's images, K2's two a step, K1's two passes an
     image in runs of 2^20 points, finite losses, the test's MANO
     files for every image; the same files packed by
     tools/create_lmdb_torch.py, one SDFDataset item from each backend at
     one seed within 1e-6; from the files and from the LMDBs, the host's
     time for each part of an item (image, meta, norm, SDF sampling) and
     the whole item over every scene (median and 10th / 90th
     percentiles), and the loader's time a batch (an epoch's time over its
     8 batches) and its wait for the first batch, in each of 3 epochs;
 18. feeding the card from disk: 512 scenes (8 x ScenesPerBatch) and a
     2-image test split written by write_synthetic_dataset, packed by
     tools/pack_dataset_torch.py into an ASDF-pack (the native reader
     built by g++ at first use) and by tools/create_lmdb_torch.py into
     LMDBs; the host's CPU count; one native batch of 64 scenes with the
     augmentation off against the item path (images and labels equal, the
     deterministic fields and the sampled rows, rebuilt from the native batch's
     branch seeds, within 1e-5), one with it on at 1 thread and at all
     threads (bit for bit, each timed); a batch's pickled size and its
     time through a pipe from a forked child; the loader over 3 epochs of
     8 batches (each epoch's time over its batches, its first batch's
     wait and the rest's time a batch) from the pack with threads and with processes, from the LMDBs
     with both, from the files with processes; then cli.train.main for the
     flagship with the stem pool through K7 for one epoch of 40 batches
     (the TrainSplit naming each key 5 times: 40 steps) from the pack
     (--packed), from the LMDBs with thread workers and from the LMDBs with
     --loader_mode process, each followed by its post-training test at
     128^3: each step on the host clock from the end of the one before and
     the loader's wait within it (the epoch's time over its steps, over
     those past the first and over the last 8, in which the loader runs
     dry; the median, mean and range of steps 17-28, past the loader's
     start-up), steps 29-32 under torch.profiler (the idle share), K7's,
     K2's and K1's launches against the steps and the test's images, finite
     losses and the test's MANO files; then (phase 20's) the pack run again
     with --bf16: K7 and K2 on their bf16 kernels (none of the float32
     ones), K1 float32 in the test, its steady step beside the float32
     pack run's;
 19. bf16 serving: K1 (the flagship of 5), K3 (--pa_feat) and K6
     (--point_size 63 --pallas) on bf16 plans (bf16 wgmma) at full width:
     each against its plain bf16 version over both 128^3 passes of image 0
     (within BF16_LOOSE everywhere, the logits BF16_LOGIT_LOOSE of their
     largest, BF16_TIGHT at BF16_SHARE of the points; the share beyond
     BF16_TIGHT printed) and against the float32
     kernel's field (<= 5e-3, near-surface sign flips counted); K1 and K3
     also at 2 + 6 rows on the classifier specs; each timed per 128^3 pass
     beside its bf16 bound (the FLOPs at 989.4 TFLOP/s), its split-TF32
     bound and the float32 kernel; run_pipelined over 3 images with --bf16
     and ComputeDtype bfloat16 (the bf16 launches, none of the float32
     kernel, encode and grid ms, images/s, the idle share); then
     BASELINE.json's configs 1 (bare experiments/obman_30k.json) and 2
     (--mano): 3 images each at 128^3 in float32 and in bf16, each K1 pass
     against its plain version, grid ms and images/s;
 20. bf16 training (cli.train --bf16, ComputeDtype bfloat16): K2 on bf16
     wgmma with bf16 residuals against its plain bf16 version at 4 and 64 x
     2000 points on the flagship's twin trunks, the DexYCB --cls trunk
     (x_last / dx_last) and a combined trunk, and on short scenes
     (K2_BF16_SHORT_SCENES) whose blocks straddle scene boundaries (y and x_last within
     BF16_LOOSE everywhere and BF16_TIGHT at BF16_SHARE of the points, the
     residuals equal at BF16_RESID_SHARE of the entries and within one bf16
     step elsewhere, every gradient within BF16_GRAD_RTOL of the plain bf16
     backward's on the kernel's residuals, kept shares); K2 bf16 against
     float32 K2 on the same operands (y within BF16_VS_F32_TOL); K7 on bf16
     at the train shape (channels last and NCHW) and the odd shape, forward
     and backward bit for bit, timed beside its bytes bound and
     F.max_pool2d on bf16; the flagship through cli/train.make_trainer in
     bf16 and in float32 in the same call (7 steps each, each synchronized
     on the host clock: median and range; K2's launches in the dtype's
     counters; peak memory; 2 profiled steps: the device's busy and idle
     share, K2's forward, chain, reduction and bias-sum ms: colsum in
     float32, the chain's db kernel in bf16, and no colsum or split-design
     bf16 chain in the profile); K2 bf16's
     forward and backward per step against the plain bf16 versions, the
     bf16 bounds (the FLOPs at 989.4 TFLOP/s, the bytes at 3.35 TB/s) and
     split TF32's, its chain (csrc/chain_bf16_tc.cuh: with its db kernel,
     beside the bytes of a chain that writes bf16 dpre alone) by the
     profiler and its reduction alone beside
     torch.matmul on bf16 (csrc/wgrad_bf16_tc.cuh: first each step shape
     against weight_grad_reference and float64, every entry within
     WGRAD_BF16_TOL of |A_k| |B_n|, with the launcher's cluster, chunk,
     loads, and the L2 reads and atomics of its plan; the step's calls
     timed as the backward launches them); BASELINE.json's configs 1 and 2
     trained 3 steps through K2 in float32 and in bf16, then each served (1
     image at 128^3, each K1 pass against its plain version); phase 16's
     bf16-trained proof and phase 18's bf16 pack run (above);
 21. bf16 training through K4 and K5 (cli.train --bf16 on --pa_feat,
     --pa_feat --cls and latent_in (0, 2)): K4 on bf16 wgmma with bf16
     residuals, latent and table copy against its plain bf16 version at 4
     and 64 x 2000 points on the HeadNet map and projection of a synthetic
     batch, --pa_feat and --pa_feat --cls (x_last / dx_last), and K5 the
     same way on latent_in (0, 2)'s twin trunks (rows of 256 + 6; layer
     0's two weights rounded apart), with phase 20's bounds but the
     residuals' share (BF16_RESID_SHARE_DEEP: the latent among K4's, equal
     bit for bit) and K4's sampling gradients (of the table, the mean, xp
     and yp: BF16_SAMPLING_SHARE within BF16_GRAD_RTOL, one bf16 step of
     the largest everywhere), every gradient also against the plain bf16
     backward in float64 (printed); each of the three specs through
     cli/train.make_trainer in bf16 and in float32 in the same call (7
     steps each on the host clock, the kernel's launches in the dtype's
     counters, peak memory, 2 profiled steps: device busy and idle share),
     each bf16-trained model served by cli.reconstruct --bf16 (K3 bf16 for
     the pixel specs, K1 bf16 for latent_in (0, 2): the bf16 launches, one
     image at 128^3); K4 bf16's and K5 bf16's forward and backward per step
     against their plain bf16 versions, the bf16 bounds and split TF32's,
     their chains by the profiler, their reductions alone beside
     torch.matmul on bf16, and F.grid_sample on bf16 beside K4's;
 22. a latent input at the final layer (NetworkSpecs latent_in naming
     index len(dims)): the flagship with latent_in (2, 4) (K2 trains it, K1
     serves it), with --pa_feat (K4, K3) and with (0, 2, 4) (K5, K1), each
     routed as JAX's CLI routes it: the kernel against its plain version at
     4 and 64 x 2000 points in float32 (y, x_last and every gradient within
     1e-4, K2's and K5's also of float64's; the residuals) and at 64 x 2000
     in bf16 (phases 20-21's bounds; K4's d(table) against the plain bf16
     backward in float64, the kernel's and the plain version's beside),
     the first trunk's backward with a random dx_last; each variant through
     cli/train.make_trainer in bf16 and in float32 (7 steps, the kernel's
     launches in the dtype's counters, 2 profiled steps), its grid kernel
     on the trained weights over a 128^3 pass against its plain version in
     the same dtype (K3's final rows reading the latent: timed beside its
     bound and F.grid_sample), and the model served by cli.reconstruct at
     128^3 in the same dtype; each kernel's forward and backward per step
     in both dtypes beside the default spec's time and its bound;
 23. K4's band (cli.train --pixel_band, ops/pixel_train_plan.default_band:
     32 rows of the 64-row map): the band's limit in Python against the
     library's; in float32 and bf16 at 64 x 2000 points, each scene's
     points sorted by the kernel's own yp (the plan's device sort), K4 with
     the band against its plain version (phase 10's bounds in float32,
     phase 21's in bf16), every tile segment taking the window and the
     kernel's per-tile counts equal to tile_band_bounds', the banded and
     the per-tap routes within 1e-5 of each other on the same residuals,
     and in bf16 both routes' d(table) against the plain bf16 backward
     summed in float64; the share of tiles that fit on the host-sorted
     batch (data/pixel_sort.py at the GT root) at the predicted root; the
     backward and its chain kernel three ways (the unsorted batch and the
     host-sorted one on the per-tap route, the host-sorted one banded) and
     the banded backward against its plain version, its bound, the tap
     stage's bytes bound and F.grid_sample's backward at the same points;
     --pa_feat --pixel_band through make_trainer in float32 and bf16 (the
     banded counters, none of the per-tap backward), each beside the
     unsorted --pa_feat step in the same call, and served by
     cli.reconstruct; cli.train --packed --pa_feat --pixel_band over 3
     steps of 64 scenes from a pack (its native batches sorted in the
     loader's workers, K4's banded launches one a step).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  ``--record PATH`` also writes every number
measured to PATH as JSON.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional, Tuple

REPO = os.path.dirname(os.path.abspath(__file__))
FP32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
TF32_PEAK_FLOPS = 494.7e12  # H100 SXM dense TF32 on the tensor cores (data sheet)
# K1 and K3 keep float32's accuracy on the tensor cores with three TF32
# products a multiply-add (split TF32, csrc/grid_trunk_tc.cuh)
SPLIT_TF32_PRODUCTS = 3
HBM_BYTES_PER_S = 3.35e12
K1_TOL = 1e-4
K2_TOL = 1e-4
K3_TOL = 1e-4
SEED = 0
N_IMAGES = 3
CUBE_DIM = 128
TRAIN_SCENES = 64         # ScenesPerBatch of the flagship
CHECK_SCENES = (4, TRAIN_SCENES)  # K2 vs plain: a small batch and the main path's
WARM_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 5, 2
TWO_WAYS_LOSS_RTOL = 1e-5
TWO_WAYS_PARAM_ATOL = 2e-5  # a fifth of one Adam step at lr 1e-4
# the train phases' step two ways starts from the init advanced by this many
# plain steps with deterministic sums (see train_phase)
TWO_WAYS_PRE_STEPS = 2
# of each gradient's largest entry: the plain forward and K2 round
# differently, so a few units at ReLU's edge (3e-8 of them at 64 x 2000) carry
# gradient on one side only; a zeroed or wrong K2 gradient errs by ~1
TWO_WAYS_GRAD_RTOL = 1e-3
# K4: those units' per-point gradients reach the encoder through d(table) at
# single pixels, not averaged over a scene's latent as through K2's fold, and
# the sums of BatchNorm's bias gradients cancel heavily (1.3e-3 seen, led by
# encoder.bn1.bias); the run prints the plain step's own rounding floor beside it
TWO_WAYS_GRAD_RTOL_K4 = 1e-2
K2_FWD_KERNELS = ("train_fwd_tc_kernel",)
# the weight-gradient reduction's two kernels, wgrad_tc_kernel and
# wgrad_tc_kernel_n128 (csrc/wgrad_tc.cuh), share the prefix
K2_BWD_KERNELS = ("train_bwd_chain_tc_kernel", "wgrad_tc_kernel", "colsum_kernel")
K4_TOL = 1e-4
K4_FWD_KERNELS = ("pixel_train_fwd_tc_kernel",)
K4_BWD_KERNELS = ("pixel_train_bwd_chain_tc_kernel", "wgrad_tc_kernel", "colsum_kernel")
K5_TOL = 1e-4
K5_FWD_KERNELS = ("generic_train_fwd_tc_kernel",)
K5_BWD_KERNELS = ("generic_train_bwd_chain_tc_kernel", "wgrad_tc_kernel", "colsum_kernel")
K6_TOL = 1e-4
TC_TRUNK_SOURCE = "alignsdf_torch/kernels/csrc/grid_trunk_tc.cuh"  # K1's, K3's and K6's trunk
WGRAD_SOURCE = "alignsdf_torch/kernels/csrc/wgrad_tc.cuh"  # K2's, K4's and K5's dW reduction
# their bf16 backwards' dW reduction (wgrad_bf16_tc_kernel<BN, RING>: TMA,
# clusters with multicast, warp-specialised wgmma)
WGRAD_BF16_SOURCE = "alignsdf_torch/kernels/csrc/wgrad_bf16_tc.cuh"
# the bf16 reduction alone against float64 and weight_grad_reference at a
# step's shapes: every entry within this of |A_k| |B_n|, the bound of
# tests/test_torch_cuda.py's bf16 weight-gradient tests at 128,000 points
# (measured 4e-9-1.5e-7; C rounded to bf16 would err ~5e-6)
WGRAD_BF16_TOL = 1e-6
CHAIN_SOURCE = "alignsdf_torch/kernels/csrc/chain_tc.cuh"  # K2's, K4's and K5's backward chain
FWD_SOURCE = "alignsdf_torch/kernels/csrc/train_fwd_tc.cuh"  # K2's, K4's and K5's forward
# K2's and K4's forwards against the plain forward: a hidden unit whose
# pre-activation lies within rounding of 0 may be 0 on one side and a tiny
# positive value on the other (the tensor cores' split TF32 and the plain
# float32 product round differently); such a flip is allowed where that
# value is at most FLIP_TOL, a few float32 roundings of the unit's sum
FLIP_TOL = 1e-5
CHAIN_PROFILED = 3  # backward calls under the profiler that times a chain apart
K7_SHAPES = {"train": (TRAIN_SCENES, 64, 128, 128), "serving": (1, 64, 128, 128),
             "odd": (3, 5, 37, 29)}
K7_TIMED = ("train", "serving")
K7_FWD_KERNELS = ("maxpool_fwd_kernel",)
K7_BWD_KERNELS = ("maxpool_bwd_rows_kernel",)
DATASET_SCENES = 2 * TRAIN_SCENES
# steady-state feeding: an epoch of many batches, timed after the loader's
# start-up (its first STEADY_SKIP steps), STEADY_PROFILED of them profiled
STEADY_SCENES = 24 * TRAIN_SCENES
STEADY_SKIP, STEADY_PROFILED = 6, 4
# the proof of learning (phase 16): the geometric dataset, trained as the
# JAX package's TPU run was (16 scenes, one batch an epoch, 1,400 steps, the
# cross-mesh gate at 1001, the supervision points re-drawn every 25 steps),
# reconstructed and scored through the CLIs
GEO_SCENES = 16
GEO_STEPS = 1400
GEO_REDRAW = 25
GEO_GATE = 1001
GEO_EVAL_IMAGES = 4  # the --eval_mode run and the 256^3 run
GEO_BIG_CUBE = 256
GEO_UNTRAINED_CUBE = 32  # the untrained model's run reads only its MANO joints
GEO_LOG_EVERY = 100
GEO_HAND_CHAMFER_MAX = 2.0  # cm^2, about twice the TPU's 0.993 (bf16, BASELINE.md)
GEO_OBJ_CHAMFER_MAX = 2.5  # cm^2, about twice the TPU's 1.215
GEO_HAND_SDF_DROP, GEO_OBJ_SDF_DROP = 0.35, 0.5  # tests/test_overfit.py's bounds
# the per-file layout (phase 17): 2 batches of the flagship, a 4-image test split
FILES_SCENES = 2 * TRAIN_SCENES
FILES_TEST_IMAGES = 4
FILES_ITEM_TOL = 1e-6  # the LMDB item against the per-file one (tests/test_lmdb.py)
LOADER_REPEAT = 4  # passes of the keys in an epoch of the timed loader: 8 batches
LOADER_EPOCHS = 3
# phase 18: feeding the card from a pack and from forked loader workers
PACK_SCENES = 8 * TRAIN_SCENES  # an epoch of the timed loader: 8 batches
PACK_TEST_IMAGES = 2
PACK_TRAIN_REPEAT = 5  # the TrainSplit names each key 5 times: 40 steps in the CLI's epoch
# the epoch's steps: the loader's start-up and any backlog its workers built
# while the first step waited on cuDNN's warm-up (up to workers + PREFETCH =
# 7 batches), skipped; the steady window on the host clock; then steps under
# torch.profiler; then the tail, in which the loader has no batch left to
# submit and its workers fall idle (a thread loader then stops holding the
# GIL), left out of both
PACK_STEADY_SKIP, PACK_STEADY_STEPS, PACK_PROFILED = 16, 12, 4
PACK_ITEM_TOL = 1e-5  # the native batch against the item path (the JAX package's test_native)
IPC_REPS = 5
# phase 19, bf16 serving
BF16_PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 on the tensor cores (data sheet)
# a bf16 kernel against its plain bf16 version: both round the same values
# to bf16, but their float32 sums run in other orders, so now and then a
# hidden unit rounds to the neighbouring bf16 value and the layers after it
# carry the step: within BF16_TIGHT at BF16_SHARE of the points, within
# BF16_LOOSE everywhere (the logits: BF16_LOGIT_LOOSE of their largest)
BF16_TIGHT, BF16_SHARE, BF16_LOOSE = 1e-5, 0.9, 2e-3
BF16_LOGIT_LOOSE = 5e-3  # the x40 classifier head carries a flip 40 times over
BF16_VS_F32_TOL = 5e-3  # a bf16 field against the float32 kernel's (JAX's bf16 bound)
# phase 20, bf16 training.  K2 in bf16 against its plain bf16 version, on
# the kernel's own residuals: every gradient within BF16_GRAD_RTOL of its
# largest entry; the residuals equal at BF16_RESID_SHARE of the entries and
# elsewhere within one bf16 step of the larger (the neighbouring value) or
# within BF16_LOOSE, where a unit rounded to its neighbour upstream moves a
# small one by more than its own step; a flip at ReLU's edge at most
# BF16_LOOSE
BF16_GRAD_RTOL = 2e-3
BF16_RESID_SHARE = 0.999
# phase 21: K4's and K5's first products are 256-512 deep on the tensor cores
# (K2's first layer sums 6 embedding columns on the CUDA cores), and their
# float32 sums in another order than the plain version's round ~0.1-0.25% of
# the units to the neighbouring bf16 value (tests/test_torch_cuda.py)
BF16_RESID_SHARE_DEEP = 0.995
# K4 bf16's sampling gradients (of the table, the mean, xp, yp) read dlat
# rounded to bf16, which the chain sums in another order than the plain
# backward: where one point's dlat rounds to the neighbouring bf16 value, a
# table entry it dominates moves by up to one bf16 step of that entry.  Within
# BF16_GRAD_RTOL of the largest at BF16_SAMPLING_SHARE of the entries, within
# BF16_SAMPLING_GRAD_RTOL everywhere (tests/test_torch_cuda.py: 2.1e-3-2.8e-3)
BF16_SAMPLING_SHARE, BF16_SAMPLING_GRAD_RTOL = 0.999, 2.0 ** -7
K2_BF16_FWD_KERNELS = ("train_fwd_tc_kernel<TcBf16",)
# K2's bf16 backward: its chain (csrc/chain_bf16_tc.cuh), the reduction, the
# chain's db kernel; it must launch neither the split design's bf16 chain
# nor colsum
K2_BF16_BWD_KERNELS = ("train_bwd_chain_bf16_kernel", "wgrad_bf16_tc_kernel",
                       "train_bwd_chain_bf16_db_kernel")
K2_BF16_ABSENT_KERNELS = ("train_bwd_chain_tc_kernel<TcBf16", "colsum_kernel")
CHAIN_BF16_SOURCE = "alignsdf_torch/kernels/csrc/chain_bf16_tc.cuh"  # K2's bf16 chain
# phase 20's K2 bf16 check on short scenes, whose blocks of 64 points and
# warps' 16 straddle scene boundaries: (scenes, points a scene); M = 180 is
# not a multiple of 8 (the chain's io warps copy rows instead of bulk copies)
K2_BF16_SHORT_SCENES = ((5, 36), (6, 100))
CONFIG_TRAIN_STEPS = 3  # BASELINE.json's configs 1 and 2: steps before they are served
# phase 21, bf16 training through K4 and K5: their bf16 kernels as the
# profiler names them (template kernels), and the trained models' --bf16
# serving runs, SERVE_IMAGES images each at CUBE_DIM^3
K4_BF16_FWD_KERNELS = ("pixel_train_fwd_tc_kernel<TcBf16",)
K4_BF16_BWD_KERNELS = ("pixel_train_bwd_chain_tc_kernel<TcBf16", "wgrad_bf16_tc_kernel",
                       "colsum_kernel")
K5_BF16_FWD_KERNELS = ("generic_train_fwd_tc_kernel<TcBf16",)
K5_BF16_BWD_KERNELS = ("generic_train_bwd_chain_tc_kernel<TcBf16", "wgrad_bf16_tc_kernel",
                       "colsum_kernel")
SERVE_IMAGES = 1
# phase 22, a latent input at the final layer: the flagship's NetworkSpecs
# latent_in naming the final layer (index len(dims) = 4), and with layer 0
# too; their kernels as the profiler names them are K2's, K4's and K5's
FINAL_LATENT_IN = (2, 4)
FINAL_LATENT_IN_0 = (0, 2, 4)
# phase 23, K4's band: the pack run's scenes (one batch) and its steps (the
# TrainSplit names each key that many times)
PIXEL_BAND_PACK_SCENES = TRAIN_SCENES
PIXEL_BAND_PACK_STEPS = 3



def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_STARTED = time.perf_counter()


def phase(name: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    print(f"== {name} [{time.perf_counter() - _STARTED:.1f} s]", flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, after one warm-up run."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spread(values) -> dict:
    """Median, 10th and 90th percentiles (nearest rank) and count of times."""
    v = sorted(values)
    return {"median": statistics.median(v), "p10": v[min(len(v) - 1, len(v) // 10)],
            "p90": v[min(len(v) - 1, len(v) * 9 // 10)], "n": len(v)}


def fmt_spread(s: dict) -> str:
    return f"{s['median']:.2f} [{s['p10']:.2f}, {s['p90']:.2f}]"


def flagship_specs(pixel: bool = False, experiment: str = "obman_30k.json",
                   classifier: bool = False, raw: Optional[dict] = None):
    """The flagship "Full AlignSDF" (experiments/obman_30k.json with --mano
    --obj_pose --encode both --point_size 9), with --pa_feat if ``pixel``;
    with ``experiment`` "dexycb_140k.json" and ``classifier`` (--cls), the
    labelled DexYCB full model; ``raw``, a spec dict, replaces the file."""
    from alignsdf_torch.config import apply_overrides, load_specs, specs_from_dict

    class Flags:
        mano = obj_pose = True
        encode, point_size = "both", 9
        pa_feat, cls = pixel, classifier

    specs = (specs_from_dict(raw) if raw is not None
             else load_specs(os.path.join(REPO, "experiments", experiment)))
    return apply_overrides(specs, Flags())


def synthetic_samples(gen, count: int):
    """Seeded 256x256 uint8 images with the camera, hand root and object
    corners a sample carries."""
    import numpy as np
    import torch

    def synth(i):
        img = torch.randint(0, 256, (256, 256, 3), generator=gen, dtype=torch.uint8)
        return {"image": img.numpy(),
                "cam_intr": np.array([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]],
                                     np.float32),
                "mano_root": (torch.randn(3, generator=gen) * 0.02
                              + torch.tensor([0.0, 0.0, 0.6])).numpy(),
                "rest_obj_corners": (torch.randn(8, 3, generator=gen) * 0.05).numpy(),
                "key": f"synthetic{i}"}

    return [synth(i) for i in range(count)]


def host_text(t: dict) -> str:
    """An image's host timings (Reconstructor.finalize) as one phrase."""
    names = (("marching_ms", "marching cubes"), ("lcc_ms", "largest component"),
             ("icp_ms", "ICP"), ("export_ms", "export"), ("labels_ms", "labels"),
             ("host_ms", "host in all"))
    return ", ".join(f"{label} {t[k]:.2f} ms" for k, label in names if k in t)


def scene_ctx(model, specs, sample, dev):
    """The grid context the Reconstructor builds for one sample."""
    import torch

    args = [torch.as_tensor(sample[k])[None].to(dev) for k in
            ("image", "cam_intr", "mano_root", "rest_obj_corners")]
    lat, mano, obj = model.encode_scene(*args)
    ctx = {"decoder": model.decoder, "latent": lat}
    if mano is not None:
        ctx.update(rot_center=mano["rot_center"], global_trans=mano["global_trans"])
    if obj is not None:
        ctx["obj_trans"] = obj["obj_trans"]
    if specs.pixel_align:
        ctx.update(cam_intr=args[1], pred_root=mano["joints"][:, 0:1])
    return ctx


def k1_flops_per_point(specs) -> int:
    """FLOPs of K1 for one point at the model's true (unpadded) widths: 2 per
    multiply-add of every matmul and of every folded xyz term, both trunks,
    and the classifier's rows on the hand trunk's last hidden activation."""
    from alignsdf_torch.models.decoder import separate_input_widths, trunk_layer_dims

    ns = specs.network_specs
    classes = ns.num_class if specs.classifier_branch else 0
    total = 0
    for t, in_dim in enumerate(separate_input_widths(specs.latent_size, specs.point_feat_size,
                                                     specs.encode_style)):
        cur = 0
        dims = trunk_layer_dims(in_dim, ns, 1)
        for layer, (_, out) in enumerate(dims):
            if t == 0 and layer == len(dims) - 1:
                total += 2 * cur * classes
            total += 2 * cur * out
            if layer == 0 or layer in ns.latent_in:
                total += 2 * 3 * out
            cur = out
    return total


def grid_bounds(flops: float, nbytes: float) -> dict:
    """A kernel's bounds at float32 accuracy: ``bound_ms`` is split
    TF32's (3 x the FLOPs at the tensor cores' dense TF32 rate, or the
    bytes at HBM's rate if larger); ``float32_bound_ms`` beside it is the
    CUDA cores' (the FLOPs at the float32 rate)."""
    tc_ms = SPLIT_TF32_PRODUCTS * flops / TF32_PEAK_FLOPS * 1e3
    fp32_ms = flops / FP32_PEAK_FLOPS * 1e3
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(tc_ms, mem_ms),
            "bound_by": "operations" if tc_ms >= mem_ms else "bytes",
            "split_tf32_bound_ms": tc_ms, "float32_bound_ms": max(fp32_ms, mem_ms)}


def bounds_text(b: dict) -> str:
    if b.get("bf16"):
        return (f"bf16 bound {b['bound_ms']:.2f} ms ({b['bound_by']}; the FLOPs at "
                f"{BF16_PEAK_FLOPS / 1e12:g} TFLOP/s dense bf16 {b['operations_bound_ms']:.2f} "
                f"ms, the bytes at {HBM_BYTES_PER_S / 1e12:g} TB/s {b['bytes_bound_ms']:.2f} "
                f"ms), split-TF32 bound {b['split_tf32_bound_ms']:.2f} ms")
    return (f"split-TF32 bound {b['bound_ms']:.2f} ms ({b['bound_by']}; {SPLIT_TF32_PRODUCTS} x "
            f"the FLOPs at {TF32_PEAK_FLOPS / 1e12:g} TFLOP/s dense TF32), float32 bound "
            f"{b['float32_bound_ms']:.2f} ms ({FP32_PEAK_FLOPS / 1e12:g} TFLOP/s)")


def train_bounds(flops: float, nbytes: float, bf16: bool = False) -> dict:
    """A train kernel's bounds: grid_bounds' in float32; in bf16 the larger
    of the FLOPs at dense bf16's rate and the bytes at HBM's, both given,
    with split TF32's beside (``bf16`` marks the dict for bounds_text)."""
    if not bf16:
        return grid_bounds(flops, nbytes)
    ops_ms = flops / BF16_PEAK_FLOPS * 1e3
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, mem_ms), "bound_by": "operations" if ops_ms >= mem_ms
            else "bytes", "operations_bound_ms": ops_ms, "bytes_bound_ms": mem_ms,
            "split_tf32_bound_ms": SPLIT_TF32_PRODUCTS * flops / TF32_PEAK_FLOPS * 1e3,
            "bf16": True}


def profile_summary(prof, wall_s: float):
    """(device busy ms, busy share of the wall clock, device ms by kernel
    name) of a torch.profiler run, or None if it saw no device events; busy
    is the union of the device intervals."""
    from torch.autograd import DeviceType

    kernels_ms, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # a template kernel's demangled name starts with its return type
            name = e.name.removeprefix("void ")
            kernels_ms[name] = kernels_ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        return None
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, busy / (wall_s * 1e6), kernels_ms


def kernel_ms_per_launch(prof, prefix: str) -> Optional[float]:
    """The mean device ms of the kernel launches a torch.profiler run saw
    whose names start with ``prefix``, or None where it saw none: for a
    kernel launched once a call, its time a call even where the window
    dropped a call's events (one of three has been seen; chain_timing
    divides by the launches recorded for the same reason)."""
    from torch.autograd import DeviceType

    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and e.name.removeprefix("void ").startswith(prefix)]
    return sum(times) / len(times) if times else None


def warm_and_profiled(recon, samples, kernel, card: str, label: str = ""):
    """run_pipelined over the samples warm, then once more under
    torch.profiler, ``kernel``'s launch count left as it was: (the warm
    run's record, the profiled run's or None where the profiler saw no
    device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignsdf_torch.inference.reconstruct import make_output_dirs, run_pipelined

    with tempfile.TemporaryDirectory() as out:
        dirs = make_output_dirs(out)
        saved = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_pipelined(recon, samples, dirs)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_pipelined(recon, samples, dirs)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        kernel.launches = saved
    count = len(samples)
    print(f"[{card}] {label}warm: {count} images in {warm * 1e3:.1f} ms = "
          f"{count / warm:.3f} images/s at {recon.cube_dim}^3", flush=True)
    warm_rec = {"wall_ms": warm * 1e3, "images_per_s": count / warm}
    summary = profile_summary(prof, prof_wall)
    if summary is None:
        print(f"{label}device profile: not measured (the profiler recorded no device events)",
              flush=True)
        return warm_rec, None
    busy, share, by_kernel = summary
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[{card}] {label}profiled run {prof_wall * 1e3:.1f} ms: device busy {busy:.1f} ms "
          f"({share:.3f} of the wall clock), idle share {1 - share:.3f}", flush=True)
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {name[:100]}", flush=True)
    return warm_rec, {"wall_ms": prof_wall * 1e3, "device_busy_ms": busy, "busy_share": share,
                      "top_device_ms": dict(top)}


def k2_work(ws, xs, bs, m: int, e: int, out_pads, act_bytes: int = 4):
    """(forward FLOPs, backward FLOPs, forward bytes, backward bytes) of one
    trunk over m points whose embedding (K2) or input row (K5) is e wide: 2
    per multiply-add at the true widths; the backward is dx plus dW.  Bytes
    count each input read once and each output written once, the residuals
    at the kernel's padded widths ``out_pads``, ``act_bytes`` each (2 in
    bf16)."""
    params = sum(t.numel() for t in [*ws, *xs, *bs] if t is not None)
    macs = sum(t.numel() for t in [*ws, *xs] if t is not None)
    n_out = out_pads[-1]
    resid = act_bytes * sum(out_pads[:-1]) * m
    fwd_bytes = 4 * (m * e + params + n_out * m) + resid
    # in: dy, y, residuals, emb, weights; out: d(emb), every gradient
    bwd_bytes = 4 * (2 * n_out * m + m * e + params + m * e + params) + resid
    return 2 * macs * m, 4 * macs * m, fwd_bytes, bwd_bytes


def k2_chain_work(ws, xs, m: int, e: int, out_pads, bf16: bool = False, bs=None):
    """(FLOPs, bytes) of a K2-convention backward's chain kernel over one
    trunk: its products are the forward's (dx through every W, d(input)
    through every X), 2 per multiply-add at the true widths; bytes: y, dy,
    the residuals and the weights read once, every layer's pre-activation
    gradient (padded) and d(input) written once.  In bf16 the residuals are
    2 bytes and each pre-activation gradient is written twice, 4 + 2
    bytes; given the biases ``bs`` (a chain that takes db itself: K2's bf16
    chain), once, 2 bytes, and each bias gradient written once."""
    macs = sum(t.numel() for t in [*ws, *xs] if t is not None)
    n_out = out_pads[-1]
    act, dpre = (2, 6) if bf16 else (4, 4)
    db = 0
    if bs is not None:
        dpre, db = 2, 4 * sum(b.numel() for b in bs)
    return 2 * macs * m, (4 * (2 * n_out * m + macs + m * e) + act * sum(out_pads[:-1]) * m
                          + dpre * sum(out_pads) * m + db)


def chain_timing(label: str, chain_kernel: str, bwd, flops: float, nbytes: float,
                 card: str, bf16: bool = False, per_call: int = 1,
                 db_kernel: Optional[str] = None) -> Optional[dict]:
    """A backward's chain kernel timed apart: its device time per call of
    ``bwd`` (``per_call`` chain launches: one a trunk for K2 and K5, one for
    K4's two) from torch.profiler over CHAIN_PROFILED calls (after one
    warm-up), as the mean of the launches the profiler recorded (a window
    may drop a call's events) times per_call, beside the split-TF32 and
    float32 bounds of its work; with ``db_kernel`` (a chain that takes db
    itself), that kernel's mean launch time added, each call launching one
    after each chain.  None where the profiler saw no device event or no
    chain launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CHAIN_PROFILED):
            bwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = profile_summary(prof, wall)
    if summary is None:
        print(f"{label} chain: not measured (the profiler recorded no device events)", flush=True)
        return None
    launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name.removeprefix("void ").startswith(chain_kernel))
    if not launches:
        print(f"{label} chain: not measured (the profiler recorded no {chain_kernel} launch)",
              flush=True)
        return None
    ms = (sum(v for k, v in summary[2].items() if k.startswith(chain_kernel)) / launches
          * per_call)
    db_ms = None
    if db_kernel is not None:
        db_launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                          and e.name.removeprefix("void ").startswith(db_kernel))
        if not db_launches:
            print(f"{label} chain: not measured (the profiler recorded no {db_kernel} launch)",
                  flush=True)
            return None
        db_ms = (sum(v for k, v in summary[2].items() if k.startswith(db_kernel)) / db_launches
                 * per_call)
        print(f"[{card}] {label} chain alone {ms:.3f} ms a step, its db kernel ({db_kernel}, "
              f"{db_launches} launches recorded) {db_ms:.3f} ms", flush=True)
        ms += db_ms
    rec = {"kernel": chain_kernel, "ms": ms, "db_ms": db_ms, "launches_recorded": launches,
           "launches_expected": CHAIN_PROFILED * per_call, **train_bounds(flops, nbytes, bf16),
           "tflop": flops / 1e12,
           "gbytes": nbytes / 1e9, "tflops": flops / ms / 1e9 if ms > 0 else None}
    with_db = " with its db" if db_kernel else ""
    print(f"[{card}] {label} backward's chain ({chain_kernel}{with_db}, profiler, {CHAIN_PROFILED} "
          f"calls: "
          f"{launches} of {CHAIN_PROFILED * per_call} launches recorded, {per_call} a call): "
          f"{ms:.2f} ms a step ({flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB, "
          f"{flops / ms / 1e9 if ms > 0 else 0.0:.1f} TFLOP/s), {bounds_text(rec)}", flush=True)
    return rec


def k2_operands(model, specs, latent, emb):
    """[(prefix, seed, embedding columns, ws, xs, bs)] of both trunks,
    detached, as ops/train_plan.py hands them to K2."""
    import torch

    from alignsdf_torch.ops.grid_plan import branch_columns
    from alignsdf_torch.ops.train_plan import trunk_operands

    out = []
    with torch.no_grad():
        for (prefix, cols), seed in zip(zip(("linh", "lino"), branch_columns(specs)), (5, 6)):
            ws, xs, bs = trunk_operands(model.decoder, prefix, len(cols), latent, specs, 1)
            out.append((prefix, seed, emb[:, list(cols)].contiguous(), ws, xs, bs))
    return out


def k2_check(model, specs, dev, gen, scenes: int, x_last: bool = False, inputs=None):
    """K2 forward and backward on both trunks against their plain versions
    on the same card, at scenes x 2000 points: on random latents and point
    embeddings, or on ``inputs`` (latent, embedding) where given.  With
    ``x_last``, the hand trunk's backward takes a nonzero random dx_last."""
    import torch

    from alignsdf_torch.ops.train_plan import make_train_decoder

    st = make_train_decoder(specs).statics
    if inputs is None:
        latent = (torch.randn(scenes, specs.latent_size, generator=gen) * 0.5).to(dev)
        emb = (torch.randn(scenes * specs.samples_per_scene, specs.point_feat_size,
                           generator=gen) * 0.5).to(dev)
    else:
        latent, emb = inputs
    return trunk_check(k2_kernel(), k2_operands(model, specs, latent, emb), st, dev, gen, x_last)


def k2_verdict(k2: dict, label: str) -> None:
    """Print a K2 check and fail unless its forward, residuals, gradients
    (against the plain backward and float64), dropout kept shares and
    residual gating hold."""
    print(f"K2 y max abs err {k2['y_max_abs_err']:.3e} (tolerance {K2_TOL:g}); "
          f"{forward_text(k2)}; gradients "
          f"max err {k2['grad_max_abs_err']:.3e} abs, {k2['grad_max_rel_err']:.3e} of the "
          f"largest, {k2['grad_f64_max_rel_err']:.3e} of float64's (tolerance {K2_TOL:g}); "
          f"kept share {k2['kept_share']}; residual sign "
          f"mismatch {k2['residual_sign_mismatch']:.2e}", flush=True)
    if not (k2["y_max_abs_err"] <= K2_TOL and k2["grad_max_rel_err"] <= K2_TOL
            and k2["grad_f64_max_rel_err"] <= K2_TOL):
        fail(f"K2 disagrees with its plain version {label}")
    forward_verdict(k2, "K2", K2_TOL)
    if len(k2["kept_share"]) != 8 or not all(abs(v - 0.8) <= 0.01
                                             for v in k2["kept_share"].values()):
        fail(f"kept shares off 0.8 +- 0.01 {label}: {k2['kept_share']}")
    if not k2["residual_sign_mismatch"] <= 1e-4:
        fail(f"K2's residuals are not gated as the plain version's {label}")


def k2_bf16_verdict(k2: dict, label: str, name: str = "K2 bf16",
                    resid_share: float = BF16_RESID_SHARE) -> None:
    """Print a bf16 check of ``name`` (K2, K4 or K5; trunk_check's or
    k4_check's record) and fail unless y lies within BF16_LOOSE of the
    plain bf16 forward everywhere and y and x_last within BF16_TIGHT at
    BF16_SHARE of the points, the residuals are equal at ``resid_share``
    of the entries and elsewhere within one bf16 step or BF16_LOOSE (flips
    at most BF16_LOOSE), every gradient within BF16_GRAD_RTOL of its largest against
    the plain bf16 backward on the kernel's residuals, and the kept shares
    and gating hold."""
    print(f"{name} y max abs err {k2['y_max_abs_err']:.3e} ({k2['y_share_tight']:.5f} within "
          f"{BF16_TIGHT:g}), x_last {k2['x_last_max_abs_err']:.3e} "
          f"({k2['x_last_share_tight']:.5f}); residuals equal at "
          f"{k2['residual_equal_share']:.6f} of the entries, {k2['residual_beyond_step']} beyond "
          f"one bf16 step and {BF16_LOOSE:g}, {k2['flips']} flips at ReLU's edge (largest value "
          f"{k2['flip_max']:.3e}); gradients max err {k2['grad_max_abs_err']:.3e} abs, "
          f"{k2['grad_max_rel_err']:.3e} of the largest (tolerance {BF16_GRAD_RTOL:g}), "
          f"{k2['grad_f64_max_rel_err']:.3e} of the plain bf16 backward's in float64; kept share "
          f"{k2['kept_share']}", flush=True)
    # x_last is the last residual: its largest error is held as theirs
    if not (k2["y_max_abs_err"] <= BF16_LOOSE and k2["y_share_tight"] >= BF16_SHARE
            and k2["x_last_share_tight"] >= BF16_SHARE):
        fail(f"{name}'s forward disagrees with its plain bf16 version {label}")
    if not (k2["residual_equal_share"] >= resid_share and k2["residual_beyond_step"] == 0
            and k2["flip_max"] <= BF16_LOOSE):
        fail(f"{name}'s residuals disagree with the plain bf16 ones {label}")
    if not k2["grad_max_rel_err"] <= BF16_GRAD_RTOL:
        fail(f"{name}'s gradients disagree with the plain bf16 backward {label}")
    if not all(abs(v - 0.8) <= 0.01 for v in k2["kept_share"].values()):
        fail(f"kept shares off 0.8 +- 0.01 {label}: {k2['kept_share']}")
    if not k2["residual_sign_mismatch"] <= 1e-4:
        fail(f"{name}'s residuals are not gated as the plain version's {label}")


def residual_check(acts_k, acts_ref) -> dict:
    """A train forward's residuals against the plain forward's gated
    activations (each (M, out)): the largest abs difference where both are
    positive, the flips (0 on one side, positive on the other) and the
    largest value at a flip."""
    both_err, flips, flip_max = 0.0, 0, 0.0
    for a_k, a_r in zip(acts_k, acts_ref):
        pos_k, pos_r = a_k > 0, a_r > 0
        diff = (a_k - a_r).abs()
        both, flip = pos_k & pos_r, pos_k != pos_r
        if bool(both.any()):
            both_err = max(both_err, float(diff[both].max()))
        n = int(flip.sum())
        if n:
            flips += n
            flip_max = max(flip_max, float(diff[flip].max()))
    return {"residual_max_abs_err": both_err, "flips": flips, "flip_max": flip_max}


def forward_text(res: dict) -> str:
    return (f"y vs float64 {res['y_f64_max_abs_err']:.3e}; residuals {res['residual_max_abs_err']:.3e} "
            f"where both are positive, {res['flips']} flips at ReLU's edge (largest value "
            f"{res['flip_max']:.3e}, bound {FLIP_TOL:g})")


def forward_verdict(res: dict, name: str, tol: float) -> None:
    """Fail unless the forward's y lies within tol of the float64 forward
    and its residuals within tol of the plain ones where both are positive,
    with flips only within FLIP_TOL of 0."""
    if not (res["y_f64_max_abs_err"] <= tol and res["residual_max_abs_err"] <= tol
            and res["flip_max"] <= FLIP_TOL):
        fail(f"{name}'s forward: y or its residuals disagree ({forward_text(res)})")


def _f64(ts):
    return [None if t is None else t.double() for t in ts]


def trunk_check(kern, trunks, st, dev, gen, x_last: bool):
    """A K2-convention train kernel (K2, K5) on each trunk [(prefix, seed,
    input, ws, xs, bs)] through its autograd Function against the plain
    forward (y, x_last) and the plain backward fed the kernel's own
    residuals (the forward is deterministic: autograd through the plain
    forward would differ wherever rounding flips a unit at ReLU's edge) and
    against that plain backward in float64; with ``x_last`` the first
    trunk's backward takes a random dx_last.  Also each dropout layer's
    kept share and the residuals' gating."""
    import torch

    from alignsdf_torch.kernels.train_decoder import dropout_gate, flatten_params, unflatten_params

    saved = launch_counts(kern)
    res = {"y_max_abs_err": 0.0, "x_last_max_abs_err": 0.0, "grad_max_rel_err": 0.0,
           "grad_max_abs_err": 0.0, "d_input_max_rel_err": 0.0, "grad_f64_max_rel_err": 0.0,
           "kept_share": {},
           "residual_sign_mismatch": 0.0, "y_f64_max_abs_err": 0.0,
           "residual_max_abs_err": 0.0, "flips": 0, "flip_max": 0.0,
           "y_share_tight": 1.0, "x_last_share_tight": 1.0, "residual_equal_share": 1.0,
           "residual_beyond_step": 0}
    for i, (prefix, seed, e, ws, xs, bs) in enumerate(trunks):
        leaves = [t.detach().clone().requires_grad_() for t in [e, *flatten_params(ws, xs, bs)]]
        y, xl = kern.fwd(leaves[0], *unflatten_params(st, leaves[1:]), seed, st)
        dy = torch.randn(tuple(y.shape), generator=gen).to(dev)
        dxl = torch.randn(tuple(xl.shape), generator=gen).to(dev) if x_last and i == 0 else None
        grads = (torch.autograd.grad(y, leaves, dy) if dxl is None
                 else torch.autograd.grad((y, xl), leaves, (dy, dxl)))
        torch.cuda.synchronize()
        with torch.no_grad():
            acts_ref = []
            y_ref, xl_ref = kern.plain(e, ws, xs, bs, seed, st, acts=acts_ref)
            res["y_max_abs_err"] = max(res["y_max_abs_err"], float((y - y_ref).abs().max()))
            res["x_last_max_abs_err"] = max(res["x_last_max_abs_err"],
                                            float((xl - xl_ref).abs().max()))
            for key, a, b in (("y_share_tight", y, y_ref), ("x_last_share_tight", xl, xl_ref)):
                res[key] = min(res[key], float(((a - b).abs() <= BF16_TIGHT).float().mean()))
            y64, _ = kern.plain(e.double(), _f64(ws), _f64(xs), _f64(bs), seed, st)
            res["y_f64_max_abs_err"] = max(res["y_f64_max_abs_err"],
                                           float((y.double() - y64).abs().max()))
            y_k, acts = kern.forward(kern.pack(e, ws, xs, bs, st), seed, st)
            acts_k = [a[:r.shape[1]].T.float() for a, r in zip(acts, acts_ref)]
            rc = residual_check(acts_k, acts_ref)
            equal = sum(int((a == r).sum()) for a, r in zip(acts_k, acts_ref))
            res["residual_equal_share"] = min(res["residual_equal_share"],
                                              equal / sum(r.numel() for r in acts_ref))
            # beyond one bf16 step of the larger value and beyond BF16_LOOSE
            # (information in float32)
            res["residual_beyond_step"] += sum(
                int(((a - r).abs() > torch.clamp(2.0 ** -7 * torch.maximum(a, r),
                                                 min=BF16_LOOSE)).sum())
                for a, r in zip(acts_k, acts_ref))
            res["residual_max_abs_err"] = max(res["residual_max_abs_err"],
                                              rc["residual_max_abs_err"])
            res["flips"] += rc["flips"]
            res["flip_max"] = max(res["flip_max"], rc["flip_max"])
            d_in, dws, dxs, dbs = kern.plain_backward(e, ws, xs, bs, st, y_k, acts_k, dy, dxl)
            exact = kern.plain_backward(e.double(), _f64(ws), _f64(xs), _f64(bs), st, y_k.double(),
                                        _f64(acts_k), dy.double(),
                                        None if dxl is None else dxl.double())
            for j, (g, r, r64) in enumerate(zip(grads, [d_in, *flatten_params(dws, dxs, dbs)],
                                                [exact[0], *flatten_params(*exact[1:])])):
                err = float((g - r).abs().max())
                rel = err / (float(r.abs().max()) + 1e-30)
                res["grad_max_abs_err"] = max(res["grad_max_abs_err"], err)
                res["grad_max_rel_err"] = max(res["grad_max_rel_err"], rel)
                res["grad_f64_max_rel_err"] = max(
                    res["grad_f64_max_rel_err"],
                    float((g.double() - r64).abs().max()) / (float(r64.abs().max()) + 1e-30))
                if j == 0:
                    res["d_input_max_rel_err"] = max(res["d_input_max_rel_err"], rel)
            rows = torch.arange(e.shape[0], device=dev)
            for layer, (a_k, a_r) in enumerate(zip(acts_k, acts_ref)):
                mism = float(((a_k > 0) != (a_r > 0)).float().mean())
                res["residual_sign_mismatch"] = max(res["residual_sign_mismatch"], mism)
                if st.dropout[layer]:
                    kept = (dropout_gate(seed, layer, rows, a_r.shape[1], st.keep) > 0)
                    res["kept_share"][f"{prefix}{layer}"] = float(kept.float().mean())
    restore_counts(kern, saved)
    return res


def launch_counts(kern) -> tuple:
    """A train kernel's four launch counters: float32 and bf16, fwd and bwd."""
    return tuple(getattr(fn, attr, 0) for fn in (kern.fwd, kern.bwd)
                 for attr in ("launches", "bf16_launches"))


def restore_counts(kern, saved: tuple) -> None:
    (kern.fwd.launches, kern.fwd.bf16_launches, kern.bwd.launches,
     kern.bwd.bf16_launches) = saved


NUDGE = 1.0 + 2.0 ** -23  # scales a float32 by about one rounding step


class TrainKernel(NamedTuple):
    """The train kernel a train phase drives: its wrappers (each counting
    its launches), launches of each per step, the spec's train decoder
    factory, the kernel's plain version and that plain version on its
    (latent and) embedding input scaled by NUDGE, its device kernels'
    names, and its packing, raw forward and plain backward."""

    name: str
    fwd: Callable
    bwd: Callable
    per_step: int
    make_decoder: Callable  # (specs, kernel) -> decode
    plain: Callable
    nudged: Callable
    fwd_kernels: Tuple[str, ...]
    bwd_kernels: Tuple[str, ...]
    grad_rtol: float  # one step two ways: each gradient, of its largest entry
    pack: Callable
    forward: Callable
    plain_backward: Callable
    # kernels its route must not launch (the profiler's names)
    absent_kernels: Tuple[str, ...] = ()
    # its chain writes dpre once, in bf16, and takes db itself through its
    # db kernel (bwd_kernels[2]), timed with it (K2's bf16 chain)
    chain_db: bool = False


def k2_kernel() -> TrainKernel:
    from alignsdf_torch.kernels.train_decoder import (
        pack_trunk, train_decode, train_decode_backward, train_decode_backward_reference,
        train_decode_forward, train_decode_reference)
    from alignsdf_torch.ops.train_plan import make_train_decoder

    def nudged(emb, *rest):
        return train_decode_reference(emb * NUDGE, *rest)

    return TrainKernel("K2", train_decode, train_decode_backward, 2, make_train_decoder,
                       train_decode_reference, nudged, K2_FWD_KERNELS, K2_BWD_KERNELS,
                       TWO_WAYS_GRAD_RTOL, pack_trunk, train_decode_forward,
                       train_decode_backward_reference)


def k2_bf16_kernel() -> TrainKernel:
    """K2 on a bf16 pack: the same wrappers, counted by their bf16_launches
    (``launch_counts``); its plain version is the plain bf16 one (the
    statics' dtype)."""
    return k2_kernel()._replace(name="K2 bf16", fwd_kernels=K2_BF16_FWD_KERNELS,
                                bwd_kernels=K2_BF16_BWD_KERNELS, grad_rtol=BF16_GRAD_RTOL,
                                absent_kernels=K2_BF16_ABSENT_KERNELS, chain_db=True)


def k4_kernel() -> TrainKernel:
    from alignsdf_torch.kernels.pixel_train_decoder import (
        pack_pixel_trunks, pixel_train_decode, pixel_train_decode_backward,
        pixel_train_decode_backward_reference, pixel_train_decode_forward,
        pixel_train_decode_reference)
    from alignsdf_torch.ops.pixel_train_plan import make_pixel_train_decoder

    def nudged(table, mean, *rest):
        return pixel_train_decode_reference(table * NUDGE, mean * NUDGE, *rest)

    return TrainKernel("K4", pixel_train_decode, pixel_train_decode_backward, 1,
                       make_pixel_train_decoder, pixel_train_decode_reference, nudged,
                       K4_FWD_KERNELS, K4_BWD_KERNELS, TWO_WAYS_GRAD_RTOL_K4, pack_pixel_trunks,
                       pixel_train_decode_forward, pixel_train_decode_backward_reference)


def train_phase(specs, dev, card, kern: TrainKernel):
    """A train step at full width through cli/train.make_trainer: launch
    counts, losses, ms/step and time by phase; one step two ways (through
    the kernel and through its plain version); a profiled window.  Returns
    (state, record)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignsdf_torch.cli.train import make_trainer
    from alignsdf_torch.data.synthetic import synthetic_train_batch
    from alignsdf_torch.training.train_state import TrainState
    from alignsdf_torch.training.train_step import batch_to_device, draw_seed, make_train_step

    def twin_state(src, model_sd=None, opt_sd=None):
        """A copy of the TrainState src, or of its model and optimizer with
        the given state dicts loaded."""
        twin = copy.deepcopy(src.model)
        if model_sd is not None:
            twin.load_state_dict(model_sd)
        opt = type(src.optimizer)(twin.parameters(), **src.optimizer.defaults)
        opt.load_state_dict(copy.deepcopy(opt_sd or src.optimizer.state_dict()))
        return TrainState(twin, opt, src.epoch)

    rec = {}
    t0 = time.perf_counter()
    state, step = make_trainer(specs, dev, seed=SEED, init_guard=True)
    batch = batch_to_device(synthetic_train_batch(specs, TRAIN_SCENES, seed=SEED), dev)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    # the seeded init, kept on the host for the step two ways
    init_sd = ({k: v.to("cpu", copy=True) for k, v in state.model.state_dict().items()},
               copy.deepcopy(state.optimizer.state_dict()))
    gen = torch.Generator().manual_seed(SEED)
    model = state.model
    before = {k: p.detach().clone() for k, p in model.named_parameters()}

    kern.fwd.launches = kern.bwd.launches = 0
    losses, marks = [], []
    for _ in range(WARM_STEPS):
        losses.append(step(state, batch, draw_seed(gen)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        evs = {}

        def mark(name, evs=evs):
            evs[name] = torch.cuda.Event(enable_timing=True)
            evs[name].record()

        mark("start")
        losses.append(step(state, batch, draw_seed(gen), mark=mark))
        marks.append(evs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED_STEPS
    launches = {"fwd": kern.fwd.launches, "bwd": kern.bwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = WARM_STEPS + TIMED_STEPS
    expected = kern.per_step * n_steps
    print(f"train steps {n_steps} at {TRAIN_SCENES} x {specs.samples_per_scene}: {kern.name} "
          f"launches {launches} (expected {expected} each: {kern.per_step} a step); peak device "
          f"memory {peak_gb:.2f} GB", flush=True)
    if launches != {"fwd": expected, "bwd": expected}:
        fail(f"{kern.name} launches {launches} != {expected} each")
    totals = []
    for i, lo in enumerate(losses):
        vals = {k: float(v) for k, v in lo.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"step {i}: non-finite loss {vals}")
        totals.append(vals["total"])
    print("total loss by step on the fixed batch: " + ", ".join(f"{t:.5f}" for t in totals),
          flush=True)
    if "cls" in losses[0]:
        rec["cls"] = [float(lo["cls"]) for lo in losses]
        print("cls loss by step: " + ", ".join(f"{c:.6f}" for c in rec["cls"]), flush=True)
    if not totals[-1] < totals[0]:
        fail(f"the total loss did not fall on the fixed batch: {totals[0]} -> {totals[-1]}")
    still = [k for k, p in model.named_parameters() if torch.equal(p.detach(), before[k])]
    if still:
        fail(f"parameters did not move: {still[:5]}")
    names = ("inputs", "decoder", "loss", "backward", "optimizer")
    phase_ms = {n: float(np.mean([ev[prev].elapsed_time(ev[n]) for ev in marks]))
                for prev, n in zip(("start",) + names[:-1], names)}
    print(f"[{card}] train step {wall * 1e3:.2f} ms on the host clock "
          f"({TRAIN_SCENES / wall:.2f} scenes/s); CUDA events by phase (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in phase_ms.items()), flush=True)
    rec.update({"launches": launches, "totals": totals, "step_ms": wall * 1e3,
                "scenes_per_s": TRAIN_SCENES / wall, "phase_ms": phase_ms,
                "peak_memory_gb": peak_gb})

    # one step two ways from the same state and seed, and the plain step once
    # more with the decoder's input scaled by NUDGE: a perturbation of rounding
    # size where the kernel and its plain version differ, whose effect is the
    # comparison's floor.  The state is the seeded init advanced by
    # TWO_WAYS_PRE_STEPS plain steps, every sum deterministic, so it is the
    # same in every run: from the trained state, which the kernels' atomic
    # sums and cuDNN's free algorithm choice make differ from run to run, the
    # floor ranged over 2.8e-4 to 1.4e-2 of the largest gradient (K4).  The
    # pre-steps give Adam's moments more than one gradient, so that a
    # rounding-size change of a gradient moves the update by as little.
    plain_step = make_train_step(specs, kern.make_decoder(specs, kernel=kern.plain))
    floor_step = make_train_step(specs, kern.make_decoder(specs, kernel=kern.nudged))
    saved = kern.fwd.launches, kern.bwd.launches
    # deterministic cuDNN and index_add_, so that the kernel is all that
    # differs: otherwise the encoder's gradients differ between two plain steps
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        pre_gen = torch.Generator().manual_seed(SEED + 1)
        start = twin_state(state, *init_sd)
        for _ in range(TWO_WAYS_PRE_STEPS):
            plain_step(start, batch, draw_seed(pre_gen))
        kernel_state, plain_state, floor_state = (twin_state(start) for _ in range(3))
        del start
        twin = plain_state.model
        seed = draw_seed(pre_gen)
        lk = {k: float(v) for k, v in step(kernel_state, batch, seed).items()}
        torch.cuda.reset_peak_memory_stats()
        lp = {k: float(v) for k, v in plain_step(plain_state, batch, seed).items()}
        plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        floor_step(floor_state, batch, seed)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    kern.fwd.launches, kern.bwd.launches = saved
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    twin_params = dict(twin.named_parameters())
    param_err = max(float((p.detach() - twin_params[k].detach()).abs().max())
                    for k, p in kernel_state.model.named_parameters())
    # every gradient of the step (the optimizer leaves them in place), each
    # against the plain step's, relative to its largest entry: Adam's update
    # barely sees a wrong gradient, these do
    floor_params = dict(floor_state.model.named_parameters())
    grad_rel, floor = {}, 0.0
    for k, p in kernel_state.model.named_parameters():
        ref = twin_params[k].grad
        scale = float(ref.abs().max()) + 1e-30
        grad_rel[k] = float((p.grad - ref).abs().max()) / scale
        floor = max(floor, float((floor_params[k].grad - ref).abs().max()) / scale)
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:4]
    worst_decoder = max(v for k, v in grad_rel.items() if k.startswith("decoder."))
    print(f"one step two ways ({kern.name} vs plain): losses max rel err {loss_rel:.3e} (tolerance "
          f"{TWO_WAYS_LOSS_RTOL:g}), updated parameters max abs err {param_err:.3e} "
          f"(tolerance {TWO_WAYS_PARAM_ATOL:g}), gradients max err of the largest "
          f"{worst[0][1]:.3e}, of the decoder's {worst_decoder:.3e} (tolerance "
          f"{kern.grad_rtol:g}; worst " + ", ".join(f"{k} {v:.2e}" for k, v in worst)
          + f"); the plain step against itself with the decoder's input scaled by 1 + 2^-23: "
          f"gradients max err of the largest {floor:.3e}; the plain step's peak device memory "
          f"{plain_peak_gb:.2f} GB", flush=True)
    if not (loss_rel <= TWO_WAYS_LOSS_RTOL and param_err <= TWO_WAYS_PARAM_ATOL
            and worst[0][1] <= kern.grad_rtol):
        fail(f"the step through {kern.name} and through its plain version disagree")
    rec["two_ways"] = {"loss_max_rel_err": loss_rel, "param_max_abs_err": param_err,
                       "grad_max_rel_err": grad_rel, "rounding_floor_grad_max_rel_err": floor,
                       "plain_peak_memory_gb": plain_peak_gb}
    del twin, kernel_state, plain_state, floor_state

    saved = kern.fwd.launches, kern.bwd.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(state, batch, draw_seed(gen))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern.fwd.launches, kern.bwd.launches = saved
    summary = profile_summary(prof, prof_wall)
    if summary is None:
        print("train profile: not measured (the profiler recorded no device events)", flush=True)
    else:
        busy, share, by_kernel = summary
        per = {"busy": busy,
               "fwd": sum(v for k, v in by_kernel.items() if k.startswith(kern.fwd_kernels)),
               "bwd": sum(v for k, v in by_kernel.items() if k.startswith(kern.bwd_kernels))}
        per = {k: v / PROFILED_STEPS for k, v in per.items()}
        per["other"] = per["busy"] - per["fwd"] - per["bwd"]
        print(f"[{card}] {PROFILED_STEPS} profiled steps, {prof_wall * 1e3 / PROFILED_STEPS:.2f} "
              f"ms each: device busy {per['busy']:.2f} ms a step, idle share {1 - share:.3f}; "
              f"{kern.name} fwd {per['fwd']:.2f} ms, {kern.name} bwd {per['bwd']:.2f} ms, the "
              f"rest (encoder fwd+bwd, plan, losses, optimizer) {per['other']:.2f} ms", flush=True)
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms / PROFILED_STEPS:9.3f} ms/step  {name[:100]}", flush=True)
        rec["profile"] = {"step_wall_ms": prof_wall * 1e3 / PROFILED_STEPS,
                          "idle_share": 1 - share, "per_step_ms": per}
    state.optimizer.zero_grad(set_to_none=True)
    return state, rec


def tf32_step_ms(specs, state, dev, card) -> float:
    """The flagship train step's host-clock ms with cuDNN's TF32 on
    (PyTorch's default: the encoder's convolutions in TF32, matmuls in
    float32), 1 warm-up and TIMED_STEPS timed steps, no check: not the mode
    the CLIs run (they call use_float32_precision), a number for weighing a
    faster mode."""
    import torch

    from alignsdf_torch import use_float32_precision
    from alignsdf_torch.data.synthetic import synthetic_train_batch
    from alignsdf_torch.kernels.train_decoder import train_decode, train_decode_backward
    from alignsdf_torch.training.train_step import batch_to_device, draw_seed, make_train_step

    step = make_train_step(specs)
    batch = batch_to_device(synthetic_train_batch(specs, TRAIN_SCENES, seed=SEED), dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    saved = train_decode.launches, train_decode_backward.launches
    torch.backends.cudnn.allow_tf32 = True
    try:
        step(state, batch, draw_seed(gen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step(state, batch, draw_seed(gen))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    finally:
        use_float32_precision()
        train_decode.launches, train_decode_backward.launches = saved
    state.optimizer.zero_grad(set_to_none=True)
    print(f"[{card}] flagship train step with cuDNN TF32 on (PyTorch's default; not the CLIs' "
          f"mode, no check): {ms:.2f} ms on the host clock over {TIMED_STEPS} steps "
          f"({TRAIN_SCENES / ms * 1e3:.2f} scenes/s)", flush=True)
    return ms


def k2_timing(model, specs, dev, gen, card, x_last: bool = False):
    """K2 forward and backward per step (both trunks at TRAIN_SCENES x 2000)
    against their plain versions and bounds; with ``x_last``, the hand
    trunk's backward takes a random dx_last, whose read the bytes count."""
    import torch

    from alignsdf_torch.ops.train_plan import make_train_decoder

    st = make_train_decoder(specs).statics
    m = TRAIN_SCENES * specs.samples_per_scene
    latent = (torch.randn(TRAIN_SCENES, specs.latent_size, generator=gen) * 0.5).to(dev)
    emb = (torch.randn(m, specs.point_feat_size, generator=gen) * 0.5).to(dev)
    return trunk_timing(k2_kernel(), k2_operands(model, specs, latent, emb), st, dev, gen, card,
                        x_last)


def trunk_timing(kern, trunks, st, dev, gen, card, x_last: bool):
    """A K2-convention train kernel's forward and backward per step over
    the trunks [(prefix, seed, input, ws, xs, bs)] against their plain
    versions and bounds (k2_work); with ``x_last``, the first trunk's
    backward takes a random dx_last, whose read the bytes count.  A bf16
    trunk (``st.dtype``) takes the bf16 bounds and bytes."""
    import torch

    bf16 = getattr(st, "dtype", torch.float32) == torch.bfloat16
    m = trunks[0][2].shape[0]
    packs = [kern.pack(e, ws, xs, bs, st) for _, _, e, ws, xs, bs in trunks]
    work = [k2_work(ws, xs, bs, m, e.shape[1], p.out_pads, 2 if bf16 else 4)
            for (_, _, e, ws, xs, bs), p in zip(trunks, packs)]
    fwd_flops, bwd_flops, fwd_bytes, bwd_bytes = (sum(w[i] for w in work) for i in range(4))
    chain = [k2_chain_work(ws, xs, m, e.shape[1], p.out_pads, bf16,
                           bs if kern.chain_db else None)
             for (_, _, e, ws, xs, bs), p in zip(trunks, packs)]
    chain_flops, chain_bytes = (sum(c[i] for c in chain) for i in range(2))
    saved = launch_counts(kern)
    outs = [kern.forward(p, t[1], st) for p, t in zip(packs, trunks)]
    dys = [torch.randn(tuple(y.shape), generator=gen).to(dev) for y, _ in outs]
    dxls = [torch.randn((m, t[5][-2].shape[-1]), generator=gen).to(dev) if x_last and i == 0
            else None for i, t in enumerate(trunks)]
    bwd_bytes += sum(4 * d.numel() for d in dxls if d is not None)
    chain_bytes += sum(4 * d.numel() for d in dxls if d is not None)

    def fwd_kernel():
        for p, t in zip(packs, trunks):
            kern.forward(p, t[1], st)

    def bwd_kernel():
        for p, (y, acts), dy, dxl in zip(packs, outs, dys, dxls):
            kern.bwd(p, st, y, acts, dy, dxl)

    def fwd_plain():
        with torch.no_grad():
            for _, seed, e, ws, xs, bs in trunks:
                kern.plain(e, ws, xs, bs, seed, st)

    # the plain backward takes the same residuals, at the true widths
    unpadded = [[a[:b.shape[-1]].T.float() for a, b in zip(acts, bs)]
                for (_, acts), (*_, bs) in zip(outs, trunks)]

    def bwd_plain():
        with torch.no_grad():
            for (_, _, e, ws, xs, bs), (y, _), acts, dy, dxl in zip(trunks, outs, unpadded, dys,
                                                                    dxls):
                kern.plain_backward(e, ws, xs, bs, st, y, acts, dy, dxl)

    res = {}
    for name, kfn, plain, flops, nbytes in (("fwd", fwd_kernel, fwd_plain, fwd_flops, fwd_bytes),
                                             ("bwd", bwd_kernel, bwd_plain, bwd_flops, bwd_bytes)):
        k_ms = cuda_ms(kfn, 5)        # kernel, plain, kernel: in turns on one card
        p_ms = cuda_ms(plain, 5)
        k_ms2 = cuda_ms(kfn, 5)
        best = min(k_ms, k_ms2)
        res[name] = {"ms": best, "ms_runs": [k_ms, k_ms2], "plain_ms": p_ms,
                     **train_bounds(flops, nbytes, bf16),
                     "tflop": flops / 1e12, "gbytes": nbytes / 1e9, "tflops": flops / best / 1e9}
        print(f"[{card}] {kern.name}{' with x_last' if x_last else ''} {name} per step "
              f"({len(trunks)} trunks x {m} points, {trunks[0][2].shape[1]} input columns, "
              f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB): kernel {k_ms:.2f} / "
              f"{k_ms2:.2f} ms ({res[name]['tflops']:.1f} TFLOP/s), plain {p_ms:.2f} ms, "
              f"{bounds_text(res[name])}", flush=True)
    res["bwd"]["chain"] = chain_timing(
        f"{kern.name}{' with x_last' if x_last else ''}", kern.bwd_kernels[0], bwd_kernel,
        chain_flops, chain_bytes, card, bf16, per_call=len(packs),
        db_kernel=kern.bwd_kernels[2] if kern.chain_db else None)
    restore_counts(kern, saved)
    res["bwd"]["reduction"] = reduction_timing(kern.name, [s for p in packs
                                                            for s in wgrad_shapes(p)], m, dev, card,
                                               torch.bfloat16 if bf16 else torch.float32)
    return res


def wgrad_shapes(pack):
    """(K, N) of each weight-gradient reduction a train backward runs over
    one packed trunk of K2 or K5 (dW on the previous activation, dX on the
    embedding or input row), or over K4's packed trunks (also d(Lat) on the
    latent residual), in launch order."""
    if hasattr(pack, "trunks"):  # K4
        e = pack.emb_t.shape[0]
        return [s for t in pack.trunks for w, lat, out_pad in zip(t.w, t.lat, t.out_pads)
                for s in ([tuple(w.shape)] if w is not None else [])
                + ([tuple(lat.shape), (e, out_pad)] if lat is not None else [])]
    if hasattr(pack, "x0_t"):  # K5
        e, has_x = pack.x0_t.shape[0], pack.has_x
    else:
        e, has_x = pack.emb_t.shape[0], [x is not None for x in pack.x]
    return [s for w, x, out_pad in zip(pack.w, has_x, pack.out_pads)
            for s in ([tuple(w.shape)] if w is not None else [])
            + ([(e, out_pad)] if x else [])]


def reduction_timing(name: str, shapes, m: int, dev, card: str, dtype=None) -> dict:
    """A train backward's weight-gradient reductions of one step on their
    own, through ``weight_grads`` (the kernel the backwards launch, launched
    as they launch it, on seeded operands of their shapes over m points),
    each route's share (the kernel for N <= 128 columns, and the other),
    beside torch.matmul(A, B.T) with TF32 off on the same operands, the
    split-TF32 and float32 bounds, the bytes each operand once (the
    bound's) and the design's reads from L2 (A once per 256 columns of C, B
    once per 128 rows).  With
    ``dtype`` bfloat16 the operands are bf16 (the bf16 backwards'), the
    bounds bf16's, the library call torch.matmul on bf16, and the kernel
    (csrc/wgrad_bf16_tc.cuh) is first held against weight_grad_reference
    and float64 at each shape (every entry within WGRAD_BF16_TOL of |A_k|
    |B_n|, or the run fails); its launcher's plan for each shape is printed
    (cluster, chunk, loads) and its L2 reads and atomics counted from it."""
    import torch

    from alignsdf_torch.kernels.weight_grad import (weight_grad, weight_grad_plan,
                                                    weight_grad_reference, weight_grads)

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a_of = {k: torch.randn(k, m, generator=gen, device=dev).to(dtype)
            for k in {k for k, _ in shapes}}
    b_of = {n: torch.randn(n, m, generator=gen, device=dev).to(dtype)
            for n in {n for _, n in shapes}}
    outs = [torch.zeros(k, n, device=dev) for k, n in shapes]
    routes = {"n128": [i for i, (_, n) in enumerate(shapes) if n <= 128],
              "wide": [i for i, (_, n) in enumerate(shapes) if n > 128]}
    saved = weight_grad.launches, weight_grad.bf16_launches
    plans, checks = {}, {}
    if bf16:
        for k, n in dict.fromkeys(shapes):
            plans[(k, n)] = plan = weight_grad_plan(k, n, m)
            a, b = a_of[k], b_of[n]
            c = weight_grad(a, b).double()
            scale = a.double().norm(dim=1)[:, None] * b.double().norm(dim=1)[None, :]
            errs = {"float64": float(((c - a.double() @ b.double().T).abs() / scale).max()),
                    "plain": float(((c - weight_grad_reference(a, b).double()).abs()
                                    / scale).max())}
            checks[f"{k}x{n}"] = errs
            print(f"[{card}] {name} bf16 reduction ({k}, {n}) over {m} points: tile 128 x "
                  f"{plan['bn']}, cluster {plan['ck']} x {plan['cn']} tiles, {plan['chunks']} "
                  f"chunks of {plan['chunk']} points ({plan['clusters_fit']} clusters fit), "
                  f"{'TMA' if plan['tma'] else 'producer copies'}, pieces {plan['a_piece']} / "
                  f"{plan['a_rows']} rows of A, {plan['b_piece']} / {plan['b_rows']} of B; "
                  f"error of |A_k| |B_n|: {errs['float64']:.2e} from float64, "
                  f"{errs['plain']:.2e} from weight_grad_reference (bound {WGRAD_BF16_TOL:g})",
                  flush=True)
            if not max(errs.values()) <= WGRAD_BF16_TOL:
                fail(f"{name} bf16 reduction ({k}, {n}): {errs} of |A_k| |B_n|")

    def run(idx):  # as a backward launches them (bf16: each after the first overlaps)
        weight_grads([(a_of[shapes[i][0]], b_of[shapes[i][1]]) for i in idx],
                     [outs[i] for i in idx])

    def lib():
        for k, n in shapes:
            torch.matmul(a_of[k], b_of[n].T)

    every = list(range(len(shapes)))
    k_ms = cuda_ms(lambda: run(every), 5)   # kernel, library, kernel: in turns on one card
    lib_ms = cuda_ms(lib, 5)
    k_ms2 = cuda_ms(lambda: run(every), 5)
    route_ms = {r: cuda_ms(lambda idx=idx: run(idx), 5) if idx else 0.0
                for r, idx in routes.items()}
    weight_grad.launches, weight_grad.bf16_launches = saved
    flops = sum(2 * k * n * m for k, n in shapes)
    nbytes = sum(size * (k * m + n * m) + 4 * k * n for k, n in shapes)
    atomics = None
    if bf16:  # A read once per group of clusters along N, B once per group along K
        l2_bytes, atomics = 0, 0
        for k, n in shapes:
            p = plans[(k, n)]
            tiles_k, tiles_n = -(-k // 128), -(-n // p["bn"])
            l2_bytes += size * m * (k * (tiles_n // p["cn"]) + n * (tiles_k // p["ck"]))
            atomics += p["chunks"] * k * n // (4 if p["vec_out"] else 1)
    else:
        l2_bytes = sum(size * m * (k * -(-n // 256) + n * -(-k // 128)) for k, n in shapes)
    best = min(k_ms, k_ms2)
    rec = {"ms": best, "ms_runs": [k_ms, k_ms2], "library_ms": lib_ms,
           "library": "torch.matmul(A, B.T), " + ("bf16" if bf16 else "TF32 off"),
           "source": WGRAD_BF16_SOURCE if bf16 else WGRAD_SOURCE, "calls": len(shapes),
           "shapes": [list(s) for s in shapes], "route_ms": route_ms,
           "route_share": {r: v / sum(route_ms.values()) for r, v in route_ms.items()},
           **train_bounds(flops, nbytes, bf16), "tflop": flops / 1e12, "gbytes": nbytes / 1e9,
           "l2_read_gbytes": l2_bytes / 1e9, "tflops": flops / best / 1e9}
    if bf16:
        rec.update(plans={f"{k}x{n}": p for (k, n), p in plans.items()}, check=checks,
                   atomics=atomics)
    print(f"[{card}] {name}{' bf16' if bf16 else ''} weight-gradient reduction per step "
          f"({len(shapes)} calls over {m} "
          f"points, {flops / 1e12:.3f} TFLOP, operands {nbytes / 1e9:.3f} GB once, "
          f"{l2_bytes / 1e9:.3f} GB read from L2 by the design's plan"
          + (f", {atomics} atomic instructions by the plan" if bf16 else "")
          + f"): kernel {k_ms:.3f} / {k_ms2:.3f} ms ({rec['tflops']:.1f} TFLOP/s; "
          f"routes: N > 128 "
          f"{route_ms['wide']:.2f} ms, N <= 128 {route_ms['n128']:.2f} ms, shares "
          f"{rec['route_share']['wide']:.3f} / {rec['route_share']['n128']:.3f}), "
          f"torch.matmul {lib_ms:.3f} ms, {bounds_text(rec)}", flush=True)
    return rec


def backward_entry(t: dict) -> dict:
    """A backward's kernels-line entries for its parts, or {} for a
    forward: its chain kernel timed apart (the source of its tensor-core
    design: K2's, K4's and K5's; its time and split-TF32 bound) and its
    weight-gradient reduction per step on its own (the kernel's source, its
    measured times by route and torch.matmul's, its split-TF32 bound)."""
    r = t.get("reduction")
    if r is None:
        return {}
    out = {"weight_grad_reduction": {
        "source": r["source"], "ms": r["ms"], "route_ms": r["route_ms"],
        "library_ms": r["library_ms"], "library_call": r["library"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}}
    c = t.get("chain")
    if c is not None:
        out["chain"] = {"kernel": c["kernel"], "ms": c["ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"]}
        if c["kernel"] in (K2_BWD_KERNELS[0], K4_BWD_KERNELS[0], K5_BWD_KERNELS[0],
                           K4_BF16_BWD_KERNELS[0], K5_BF16_BWD_KERNELS[0]):
            out["chain"]["source"] = CHAIN_SOURCE
        elif c["kernel"] == K2_BF16_BWD_KERNELS[0]:  # its ms holds its db kernel's
            out["chain"].update(source=CHAIN_BF16_SOURCE, db_kernel=K2_BF16_BWD_KERNELS[2],
                                db_ms=c["db_ms"])
    return out


def k3_flops(specs, points: int, sampled: int) -> int:
    """FLOPs of K3 over ``points`` grid points of which ``sampled`` lie in
    the image, at the model's true (unpadded) widths: 2 per multiply-add of
    every matmul (the latent's at layer 0 and the latent_in layers), of the
    folded xyz terms, of the classifier's rows on the hand trunk's last
    hidden activation, and of the 16 taps x C channels of each sample."""
    from alignsdf_torch.models.decoder import separate_input_widths, trunk_layer_dims

    ns, c = specs.network_specs, specs.latent_size
    classes = ns.num_class if specs.classifier_branch else 0
    per_point = 0
    for t, in_dim in enumerate(separate_input_widths(c, specs.point_feat_size,
                                                     specs.encode_style)):
        cur = 0
        dims = trunk_layer_dims(in_dim, ns, 1)
        for layer, (_, out) in enumerate(dims):
            if t == 0 and layer == len(dims) - 1:
                per_point += 2 * cur * classes
            per_point += 2 * cur * out
            if layer == 0 or layer in ns.latent_in:
                per_point += 2 * (c + 3) * out
            cur = out
    return per_point * points + 2 * 16 * c * sampled


def pixel_phase(dev, card: str, gen, mano_faces):
    """The --pa_feat flagship at full width through K3: K3 against its
    plain version over both passes of image 0, the main path (run_pipelined
    over N_IMAGES images), the field against the generic path in both
    projection modes, a warm and a profiled run, and K3's timing.  Returns
    (record, the kernels-line entry)."""
    import torch
    import torch.nn.functional as F

    from alignsdf_torch.inference.grid import _coords_from_linear, _refine_cube
    from alignsdf_torch.inference.reconstruct import Reconstructor, make_output_dirs, run_pipelined
    from alignsdf_torch.kernels.pixel_grid_decoder import (
        pixel_grid_decode, pixel_grid_decode_reference, pixel_projection)
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.embeddings import kinematic_embedding
    from alignsdf_torch.ops.geometry import pixel_alignment
    from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

    specs = flagship_specs(pixel=True)
    model = build_model(specs, device=dev, seed=SEED)
    samples = synthetic_samples(gen, N_IMAGES)
    n, chunk = CUBE_DIM, 1 << 20  # the fused evaluator's runs are 2^20 points
    total = n ** 3
    rec = {}

    def one_pass(fn, plan, origin, voxel):
        return [fn(plan, s, min(chunk, total - s), origin, voxel) for s in range(0, total, chunk)]

    def in_image(plan, origin, voxel) -> int:
        return sum(int(pixel_projection(plan, s, min(chunk, total - s), origin, voxel)[3].sum())
                   for s in range(0, total, chunk))

    origin0 = torch.full((3,), -1.0, device=dev)
    voxel0 = torch.tensor(2.0 / (n - 1), device=dev)
    shift_final_biases(model, specs, samples[0], dev)

    phase(f"K3 vs plain (both passes of image 0 at {n}^3, full --pa_feat flagship width, "
          "TF32 off)")
    plan = make_pixel_grid_decode_fn(specs, n)(scene_ctx(model, specs, samples[0], dev)).plan
    saved = pixel_grid_decode.launches
    origin, voxel = origin0, voxel0
    rec["check"] = []
    for p in (1, 2):
        k3 = torch.cat(one_pass(pixel_grid_decode, plan, origin, voxel), dim=1)
        torch.cuda.synchronize()
        with torch.no_grad():
            ref = torch.cat(one_pass(pixel_grid_decode_reference, plan, origin, voxel), dim=1)
        err = float((k3 - ref).abs().max())
        share = in_image(plan, origin, voxel) / total
        inside = float((ref < 0).float().mean())
        print(f"pass {p}: K3 max abs err vs plain {err:.3e} over {total} points (tolerance "
              f"{K3_TOL:g}); in-image share {share:.4f}; field range [{float(ref.min()):.4f}, "
              f"{float(ref.max()):.4f}], inside share {inside:.4f}", flush=True)
        if not (err <= K3_TOL):
            fail(f"K3 disagrees with its plain version in pass {p}: {err}")
        rec["check"].append({"max_abs_err": err, "in_image_share": share})
        if p == 1:
            if not 0.0 < share < 1.0:
                fail(f"pass 1's in-image share {share} must lie strictly between 0 and 1, so "
                     "that both the tap gather and the mean fallback run")
            voxel, origin = _refine_cube(specs, k3[0].reshape(n, n, n), k3[1].reshape(n, n, n),
                                         n, voxel)
    pixel_grid_decode.launches = saved
    del k3, ref
    max_err = max(c["max_abs_err"] for c in rec["check"])

    phase(f"pixel main path: run_pipelined, {N_IMAGES} images at cube_dim {n}")
    recon = Reconstructor(model, specs, cube_dim=n, mano_faces=mano_faces)
    expected = N_IMAGES * 2 * (-(-total // chunk))
    results = []
    with tempfile.TemporaryDirectory() as out:
        dirs = make_output_dirs(out)
        pixel_grid_decode.launches = 0
        t0 = time.perf_counter()
        done = run_pipelined(recon, samples, dirs, on_done=lambda i, p: results.append((i, p)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pixel_grid_decode.launches
        written = sorted(os.listdir(dirs["meshes"]))
    print(f"images {done}, wall {wall * 1e3:.1f} ms, K3 launches {launches} (expected "
          f"{expected}), meshes written {written}", flush=True)
    if done != N_IMAGES or launches != expected:
        fail(f"K3 launches {launches} != expected {expected} over {done} images")
    if not any(w.endswith("_hand.ply") for w in written) or not any(
            w.endswith("_obj.ply") for w in written):
        fail("the pixel path wrote no hand or no object mesh")
    rec["main_path"] = {"wall_ms": wall * 1e3, "launches": launches, "meshes": written,
                        "images": []}
    for i, pending in results:
        host = pending["host"]
        for name in ("sdf_hand", "sdf_obj"):
            field = host[name]
            if tuple(field.shape) != (n,) * 3 or not bool(torch.isfinite(field).all()):
                fail(f"pixel image {i}: {name} has shape {tuple(field.shape)} or non-finite values")
        t = pending["timings"]
        inside = {k: float((host[k] < 0).float().mean()) for k in ("sdf_hand", "sdf_obj")}
        print(f"pixel image {i} [{card}]: encode {t['encode_ms']:.2f} ms, grid "
              f"{t['grid_ms']:.2f} ms (2 passes), {host_text(t)}, inside fraction {inside}",
              flush=True)
        rec["main_path"]["images"].append({**t, "inside": inside})

    # the field of image 0 against the generic path (pixel_alignment + the
    # decoder on materialized rows) at 4096 grid points, in both modes
    host0 = results[0][1]["host"]
    ctx = scene_ctx(model, specs, samples[0], dev)
    origin_r, voxel_r = host0["origin"].to(dev), host0["voxel"].to(dev)
    idx = torch.randint(0, total, (4096,), generator=gen).to(dev)
    pts = _coords_from_linear(idx, n, origin_r, voxel_r)
    emb = kinematic_embedding(pts, pts.shape[0], specs.point_feat_size, specs.sdf_scale_factor,
                              specs.encode_style, rot_center=ctx["rot_center"],
                              global_trans=ctx["global_trans"], obj_trans=ctx["obj_trans"])
    rec["vs_generic_max_abs_err"] = {}
    for ref_mode in (False, True):
        if ref_mode:
            saved = pixel_grid_decode.launches
            plan_r = make_pixel_grid_decode_fn(specs, n, True)(ctx).plan
            field = torch.cat(one_pass(pixel_grid_decode, plan_r, origin_r, voxel_r), dim=1)
            pixel_grid_decode.launches = saved
            fh, fo = field[0][idx], field[1][idx]
        else:  # the main path's own field
            fh = host0["sdf_hand"].reshape(-1).to(dev)[idx]
            fo = host0["sdf_obj"].reshape(-1).to(dev)[idx]
        with torch.no_grad():
            lat = pixel_alignment(ctx["latent"], emb[:, :3] if ref_mode else pts,
                                  ctx["cam_intr"], ctx["pred_root"], specs.image_size[0],
                                  specs.sdf_scale_factor)
            gh, go, _ = model.decoder(torch.cat([lat, emb], dim=1))
        err = max(float((gh[:, 0] - fh).abs().max()), float((go[:, 0] - fo).abs().max()))
        mode = "reference projection" if ref_mode else "raw-xyz projection"
        print(f"image 0 K3 field vs generic path at 4096 grid points, {mode}: max abs err "
              f"{err:.3e}", flush=True)
        if not (err <= K3_TOL):
            fail(f"K3 disagrees with the generic path ({mode}): {err}")
        rec["vs_generic_max_abs_err"][mode] = err

    phase("pixel: warm pipelined run, then the same run under torch.profiler")
    rec["warm"], profiled = warm_and_profiled(recon, samples, pixel_grid_decode, card, "pixel ")
    if profiled is not None:
        rec["profile"] = profiled
    del recon

    phase(f"timing: K3 and plain per {n}^3 pass; F.grid_sample at the same points")
    saved = pixel_grid_decode.launches
    k3_runs = [cuda_ms(lambda: one_pass(pixel_grid_decode, plan, origin0, voxel0), 1)
               for _ in range(3)]
    pixel_grid_decode.launches = saved
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: one_pass(pixel_grid_decode_reference, plan, origin0, voxel0), 1)
    # the sampling step alone through the library call, at the pass's points
    # (image coordinates as pixel_alignment computes them)
    xyz_cam = (_coords_from_linear(torch.arange(total, device=dev), n, origin0, voxel0) * 2.0
               / specs.sdf_scale_factor + ctx["pred_root"][0])
    hom = xyz_cam @ ctx["cam_intr"][0, :3, :3].T
    uv = (hom[:, :2] / hom[:, 2:3] / specs.image_size[0] * 2.0 - 1.0)[None, None]
    lib_ms = cuda_ms(lambda: F.grid_sample(ctx["latent"], uv, mode="bicubic", align_corners=True,
                                           padding_mode="zeros"), 3)
    sampled = in_image(plan, origin0, voxel0)
    flops = k3_flops(specs, total, sampled)
    nbytes = 4 * (plan.flat.numel() + plan.table.numel() + 2 * total)
    k3_ms = min(k3_runs)
    rec["timing"] = {"k3_ms": k3_ms, "k3_runs_ms": k3_runs, "plain_ms": plain_ms,
                     "grid_sample_ms": lib_ms, **grid_bounds(flops, nbytes),
                     "tflop": flops / 1e12, "in_image_points": sampled,
                     "k3_tflops": flops / k3_ms / 1e9}
    print(f"[{card}] {n}^3 pass ({total} points, {sampled} in the image, {flops / 1e12:.3f} "
          f"TFLOP): K3 " + " / ".join(f"{t:.2f}" for t in k3_runs) + f" ms (best "
          f"{flops / k3_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
          f"{bounds_text(rec['timing'])}; F.grid_sample (sampling only) {lib_ms:.2f} ms",
          flush=True)
    entry = {
        "name": "K3 fused pixel grid decoder",
        "route": "cuda",
        "source": "alignsdf_torch/kernels/csrc/pixel_grid_decoder.cu",
        "trunk": TC_TRUNK_SOURCE,
        "replaces": "alignsdf_tpu/ops/decoder_kernel.py:884",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": rec["timing"]["bound_ms"],
        "bound_by": rec["timing"]["bound_by"],
        "library_ms": lib_ms,
        "library_call": "F.grid_sample bicubic at the pass's points (the sampling step only)",
    }
    return rec, entry


def k4_operands(model, specs, dev, scenes: int, host_sort: bool = False):
    """K4's operands on the encoder's real HeadNet map and the batch's real
    projection (the synthetic batch of ``scenes`` scenes, the front half in
    training mode): ((table, mean, xp, yp, mask, emb), trunks, statics,
    (fmap, uv)) with ``uv`` the points' normalized image coordinates, all
    detached.  ``host_sort``: the batch sorted first as cli.train
    --pixel_band's loader sorts it (at the GT root; the projection is the
    predicted root's)."""
    import torch

    from alignsdf_torch.cli.train import row_sorter
    from alignsdf_torch.data.synthetic import synthetic_train_batch
    from alignsdf_torch.ops.pixel_train_plan import (
        make_pixel_train_decoder, pixel_train_inputs, pixel_trunks)
    from alignsdf_torch.training.train_step import COND_KEYS, batch_to_device

    batch = synthetic_train_batch(specs, scenes, seed=SEED)
    batch = batch_to_device(row_sorter(specs)(batch) if host_sort else batch, dev)
    with torch.no_grad():
        fmap, emb, mano, _ = model.decoder_inputs_pixel(
            batch["image"], batch["xyz"], {k: batch[k] for k in COND_KEYS}, train=True)
        root = mano["joints"][:, 0:1]
        inputs = (*pixel_train_inputs(fmap, batch["xyz"], batch["cam_intr"], root, specs), emb)
        trunks = pixel_trunks(model.decoder, specs, fmap.shape[1])
        # the projection as pixel_alignment takes it, for F.grid_sample
        xyz_cam = batch["xyz"].reshape(scenes, -1, 3) * 2.0 / specs.sdf_scale_factor + root
        hom = torch.einsum("bij,bnj->bni", batch["cam_intr"][:, :3, :3], xyz_cam)
        uv = hom[..., :2] / hom[..., 2:3] / specs.image_size[0] * 2.0 - 1.0
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=tuple(fmap.shape[2:]))
    return inputs, trunks, st, (fmap, uv)


def k4_check(inputs, trunks, st, dev, gen, x_last: bool = False):
    """K4 forward and backward through the autograd Function against the
    plain forward and the plain backward fed the kernel's own residuals.
    With ``x_last``, the first trunk's x_last is held against the plain
    version's too and the backward takes a nonzero random dx_last.  On a
    bf16 statics (``st.dtype``) also the bf16 verdict's shares
    (k2_bf16_verdict: y and x_last within BF16_TIGHT, the residuals, the
    latent among them, equal to the plain ones) and every gradient against
    the plain bf16 backward run in float64."""
    import torch

    from alignsdf_torch.kernels.pixel_train_decoder import (
        flatten_pixel_params, pack_pixel_trunks, pixel_train_decode, pixel_train_decode_backward,
        pixel_train_decode_backward_reference, pixel_train_decode_forward,
        pixel_train_decode_reference, unflatten_pixel_params)
    from alignsdf_torch.kernels.train_decoder import dropout_gate

    table, mean, xp, yp, mask, emb = inputs
    c, m = table.shape[2], emb.shape[0]
    seed = 5
    bf16 = st.dtype == torch.bfloat16
    saved = (pixel_train_decode.launches, pixel_train_decode_backward.launches,
             pixel_train_decode.bf16_launches, pixel_train_decode_backward.bf16_launches)
    leaves = [t.detach().clone().requires_grad_()
              for t in (table, mean, xp, yp, emb, *flatten_pixel_params(trunks))]
    y, xl = pixel_train_decode(*leaves[:4], mask, leaves[4],
                               unflatten_pixel_params(st, leaves[5:]), seed, st)
    dy = torch.randn(tuple(y.shape), generator=gen).to(dev)
    dxl = torch.randn(tuple(xl.shape), generator=gen).to(dev) if x_last else None
    if dxl is None:
        grads = torch.autograd.grad(y, leaves, dy)
    else:
        grads = torch.autograd.grad((y, xl), leaves, (dy, dxl))
    torch.cuda.synchronize()
    names = ["d(table)", "d(mean)", "d(xp)", "d(yp)", "d(emb)"]
    res = {"in_image_share": float(mask.mean()), "grad_rel_err": {}, "kept_share": {}}
    with torch.no_grad():
        acts_ref, lat_ref = [], []
        y_ref, xl_ref = pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks,
                                                     seed, st, acts=acts_ref, latent=lat_ref)
        res["y_max_abs_err"] = float((y - y_ref).abs().max())
        if dxl is not None or bf16:
            res["x_last_max_abs_err"] = float((xl - xl_ref).abs().max())
        if bf16:
            for key, a, b in (("y_share_tight", y, y_ref), ("x_last_share_tight", xl, xl_ref)):
                res[key] = float(((a - b).abs() <= BF16_TIGHT).float().mean())
        y64, _ = pixel_train_decode_reference(
            *(t.double() for t in (table, mean, xp, yp)), mask, emb.double(),
            [tuple(_f64(group) for group in tr) for tr in trunks], seed, st)
        res["y_f64_max_abs_err"] = float((y.double() - y64).abs().max())
        y_k, acts, lat = pixel_train_decode_forward(
            pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st), seed, st)
        lat_k = lat[:c].T.float()
        res["latent_max_abs_err"] = float((lat_k - lat_ref[0]).abs().max())
        acts_k = [[a[:r.shape[1]].T.float() for a, r in zip(at, ar)]
                  for at, ar in zip(acts, acts_ref)]
        res.update(residual_check([a for at in acts_k for a in at],
                                  [r for ar in acts_ref for r in ar]))
        if bf16:  # the latent is a residual too
            pairs = list(zip([lat_k, *[a for at in acts_k for a in at]],
                             [lat_ref[0], *[r for ar in acts_ref for r in ar]]))
            res["residual_equal_share"] = (sum(int((a == r).sum()) for a, r in pairs)
                                           / sum(r.numel() for _, r in pairs))
            res["residual_beyond_step"] = sum(
                int(((a - r).abs() > torch.clamp(2.0 ** -7 * torch.maximum(a, r),
                                                 min=BF16_LOOSE)).sum()) for a, r in pairs)
        dtable, dmean, dxp, dyp, demb, g_ref = pixel_train_decode_backward_reference(
            table, mean, xp, yp, mask, emb, trunks, st, y_k, acts_k, lat_k, dy, dxl)
        ref = [dtable, dmean, dxp, dyp, demb, *flatten_pixel_params(g_ref)]
        if bf16:
            exact = pixel_train_decode_backward_reference(
                *(t.double() for t in (table, mean, xp, yp)), mask, emb.double(),
                [tuple(_f64(group) for group in tr) for tr in trunks], st, y_k.double(),
                [_f64(at) for at in acts_k], lat_k.double(), dy.double(),
                None if dxl is None else dxl.double())
            ref64 = [*exact[:5], *flatten_pixel_params(exact[5])]
            res["grad_f64_max_rel_err"] = max(
                float((g.double() - r).abs().max()) / (float(r.abs().max()) + 1e-30)
                for g, r in zip(grads, ref64))
            # which of the two d(table)s, the kernel's or the plain bf16
            # backward's (both float32 sums), lies farther from that
            # backward summed in float64
            scale = float(ref64[0].abs().max()) + 1e-30
            res["dtable_f64_rel_err"] = {
                who: float((t.double() - ref64[0]).abs().max()) / scale
                for who, t in (("kernel", grads[0]), ("plain", ref[0]))}
        res["grad_max_abs_err"] = res["grad_max_rel_err"] = 0.0
        res["sampling_grad_max_rel_err"], res["sampling_grad_share_tight"] = 0.0, 1.0
        for i, (g, r) in enumerate(zip(grads, ref)):
            err = float((g - r).abs().max())
            rel = err / (float(r.abs().max()) + 1e-30)
            res["grad_max_abs_err"] = max(res["grad_max_abs_err"], err)
            if bf16 and i < 4:
                # the sampling's gradients read dlat rounded to bf16 (see
                # BF16_SAMPLING_GRAD_RTOL): held apart
                share = float(((g - r).abs() <= BF16_GRAD_RTOL * float(r.abs().max()))
                              .float().mean())
                res["sampling_grad_max_rel_err"] = max(res["sampling_grad_max_rel_err"], rel)
                res["sampling_grad_share_tight"] = min(res["sampling_grad_share_tight"], share)
            else:
                res["grad_max_rel_err"] = max(res["grad_max_rel_err"], rel)
            res["grad_rel_err"][names[i] if i < len(names) else f"weights[{i - len(names)}]"] = rel
        rows = torch.arange(m, device=dev)
        mism = 0.0
        for t, (ak, ar) in enumerate(zip(acts_k, acts_ref)):
            for layer, (a_k, a_r) in enumerate(zip(ak, ar)):
                mism = max(mism, float(((a_k > 0) != (a_r > 0)).float().mean()))
                if st.dropout[layer]:
                    kept = dropout_gate(seed, layer + st.layer_offsets[t], rows, a_r.shape[1],
                                        st.keep) > 0
                    res["kept_share"][f"trunk{t}.layer{layer}"] = float(kept.float().mean())
        res["residual_sign_mismatch"] = mism
    (pixel_train_decode.launches, pixel_train_decode_backward.launches,
     pixel_train_decode.bf16_launches, pixel_train_decode_backward.bf16_launches) = saved
    return res


def k4_work(inputs, trunks, packed) -> Tuple[int, int, int, int]:
    """(forward FLOPs, backward FLOPs, forward bytes, backward bytes) of K4
    over both trunks: 2 per multiply-add at the true widths (the latent's
    and the embedding's rows of layer 0 and the latent_in layer included),
    the backward dx plus dW; the sampling's 16 taps x C per point in the
    image, once forward, twice backward (the d(table) scatter and the dot
    products of d(pix)).  Bytes count each input read once and each output
    written once, the residuals (the latent's among them) at the kernel's
    padded widths; on a bf16 pack the residuals and the table the kernels
    read are 2 bytes an entry."""
    import torch

    table, mean, xp, yp, mask, emb = inputs
    m, e = emb.shape
    c = table.shape[2]
    sampled = int(mask.sum())
    macs = params = 0
    for ws, lats, xs, bs in trunks:
        params += sum(t.numel() for t in [*ws, *lats, *xs, *bs] if t is not None)
        for w, x, b in zip(ws, xs, bs):
            # the latent and the trunk's own embedding columns (X's nonzero rows)
            cols = 0 if x is None else c + int((x.abs().sum(1) > 0).sum())
            macs += ((0 if w is None else w.shape[0]) + cols) * b.shape[-1]
    taps = 2 * 16 * c * sampled
    n_rows = sum(b[-1].shape[-1] for *_, b in trunks)
    size = 2 if packed.dtype == torch.bfloat16 else 4
    resid = size * (sum(sum(t.out_pads[:-1]) for t in packed.trunks) + packed.c_pad) * m
    fwd_in = size * table.numel() + 4 * (mean.numel() + 3 * m + m * e + params)
    fwd_bytes = fwd_in + 4 * n_rows * m + resid
    # in: the forward's inputs, dy, y, the residuals; out: d(table), d(mean),
    # d(xp), d(yp), d(emb) and every weight's gradient
    bwd_bytes = (fwd_in + 4 * 2 * n_rows * m + resid
                 + 4 * (table.numel() + mean.numel() + 2 * m + m * e + params))
    return 2 * macs * m + taps, 4 * macs * m + 2 * taps, fwd_bytes, bwd_bytes


def k4_chain_work(inputs, trunks, packed) -> Tuple[int, int]:
    """(FLOPs, bytes) of K4's backward chain kernel: the forward's products
    (k4_work) and the sampling's taps twice (the d(table) scatter and the
    dot products of d(pix)); bytes: y, dy, the residuals, the weights, the
    table, xp, yp and the mask read once, every layer's pre-activation
    gradient (padded), d(emb), d(table), d(mean), d(xp) and d(yp) written
    once (bf16: k2_chain_work's sizes, the bf16 table)."""
    import torch

    table, mean, xp, yp, mask, emb = inputs
    m, e = emb.shape
    fwd_flops, bwd_flops, _, _ = k4_work(inputs, trunks, packed)
    n_rows = sum(b[-1].shape[-1] for *_, b in trunks)
    weights = sum(t.numel() for ws, lats, xs, _ in trunks for t in [*ws, *lats, *xs]
                  if t is not None)
    acts = sum(sum(t.out_pads[:-1]) for t in packed.trunks) * m
    dpre = sum(sum(t.out_pads) for t in packed.trunks) * m
    # bf16: 2-byte residuals and table, each dpre written twice (4 + 2 bytes)
    act, tab, dp = (2, 2, 6) if packed.dtype == torch.bfloat16 else (4, 4, 4)
    nbytes = (4 * (2 * n_rows * m + weights + 3 * m + m * e + table.numel() + mean.numel()
                   + 2 * m) + act * acts + tab * table.numel() + dp * dpre)
    taps = 2 * 16 * table.shape[2] * int(mask.sum())  # one pass over the taps (k4_work's)
    # the backward's products (dx and dW) less dW's: the forward's again
    return (bwd_flops - fwd_flops) + taps, nbytes


def k4_timing(inputs, trunks, st, fmap, uv, dev, gen, card, x_last: bool = False):
    """K4 forward and backward per step (both trunks) against their plain
    versions and bounds, and F.grid_sample forward and backward at the
    step's points as yardsticks of the sampling step alone.  With
    ``x_last``, the backward takes a random dx_last, whose read the bytes
    count.  A bf16 statics (``st.dtype``) takes the bf16 bounds and bytes,
    the reductions' bf16 route and F.grid_sample on bf16."""
    import torch
    import torch.nn.functional as F

    from alignsdf_torch.kernels.pixel_train_decoder import (
        pack_pixel_trunks, pixel_train_decode, pixel_train_decode_backward,
        pixel_train_decode_backward_reference, pixel_train_decode_forward,
        pixel_train_decode_reference)

    table, mean, xp, yp, mask, emb = inputs
    c, m = table.shape[2], emb.shape[0]
    seed = 7
    bf16 = st.dtype == torch.bfloat16
    name = "K4 bf16" if bf16 else "K4"
    saved = (pixel_train_decode.launches, pixel_train_decode_backward.launches,
             pixel_train_decode.bf16_launches, pixel_train_decode_backward.bf16_launches)
    packed = pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st)
    fwd_flops, bwd_flops, fwd_bytes, bwd_bytes = k4_work(inputs, trunks, packed)
    chain_flops, chain_bytes = k4_chain_work(inputs, trunks, packed)
    y, acts, lat = pixel_train_decode_forward(packed, seed, st)
    dy = torch.randn(tuple(y.shape), generator=gen).to(dev)
    dxl = (torch.randn((m, trunks[0][3][-2].shape[-1]), generator=gen).to(dev) if x_last
           else None)
    if dxl is not None:
        bwd_bytes += 4 * dxl.numel()
        chain_bytes += 4 * dxl.numel()
    unpadded = [[a[:b.shape[-1]].T.float() for a, b in zip(at, tr[3])]
                for at, tr in zip(acts, trunks)]
    lat_plain = lat[:c].T.float()

    def fwd_kernel():
        pixel_train_decode_forward(packed, seed, st)

    def bwd_kernel():
        pixel_train_decode_backward(packed, st, y, acts, lat, dy, dxl)

    def fwd_plain():
        with torch.no_grad():
            pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks, seed, st)

    def bwd_plain():
        with torch.no_grad():
            pixel_train_decode_backward_reference(table, mean, xp, yp, mask, emb, trunks, st,
                                                  y, unpadded, lat_plain, dy, dxl)

    # the library's bicubic sampling at the same points, and its autograd
    # backward (d(input) and d(grid): the d(table) and d(pix) work), on the
    # kernel's dtype
    dt = torch.bfloat16 if bf16 else torch.float32
    fm = fmap.detach().to(dt).requires_grad_()
    grid = uv[:, None].detach().to(dt).requires_grad_()
    sampled = F.grid_sample(fm, grid, mode="bicubic", align_corners=True, padding_mode="zeros")
    g_out = torch.randn(tuple(sampled.shape), generator=gen).to(dev)

    def lib_fwd():
        with torch.no_grad():
            F.grid_sample(fm, grid, mode="bicubic", align_corners=True, padding_mode="zeros")

    def lib_bwd():
        torch.autograd.grad(sampled, (fm, grid), g_out, retain_graph=True)

    res = {}
    for part, kern, plain, lib, flops, nbytes in (
            ("fwd", fwd_kernel, fwd_plain, lib_fwd, fwd_flops, fwd_bytes),
            ("bwd", bwd_kernel, bwd_plain, lib_bwd, bwd_flops, bwd_bytes)):
        k_ms = cuda_ms(kern, 5)       # kernel, plain, kernel: in turns on one card
        p_ms = cuda_ms(plain, 3)
        k_ms2 = cuda_ms(kern, 5)
        lib_ms = cuda_ms(lib, 5)
        best = min(k_ms, k_ms2)
        res[part] = {"ms": best, "ms_runs": [k_ms, k_ms2], "plain_ms": p_ms,
                     "library_ms": lib_ms, **train_bounds(flops, nbytes, bf16),
                     "tflop": flops / 1e12, "gbytes": nbytes / 1e9, "tflops": flops / best / 1e9}
        print(f"[{card}] {name}{' with x_last' if x_last else ''} {part} per step "
              f"({len(trunks)} trunks x {m} points, "
              f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB): kernel {k_ms:.2f} / "
              f"{k_ms2:.2f} ms ({res[part]['tflops']:.1f} TFLOP/s), plain {p_ms:.2f} ms, "
              f"{bounds_text(res[part])}; F.grid_sample{' on bf16' if bf16 else ''} "
              f"{'forward' if part == 'fwd' else 'backward'} (sampling only) {lib_ms:.2f} ms",
              flush=True)
    res["bwd"]["chain"] = chain_timing(f"{name}{' with x_last' if x_last else ''}",
                                       (K4_BF16_BWD_KERNELS if bf16 else K4_BWD_KERNELS)[0],
                                       bwd_kernel, chain_flops, chain_bytes, card, bf16)
    (pixel_train_decode.launches, pixel_train_decode_backward.launches,
     pixel_train_decode.bf16_launches, pixel_train_decode_backward.bf16_launches) = saved
    res["bwd"]["reduction"] = reduction_timing("K4", wgrad_shapes(packed), m, dev, card, dt)
    return res


def pixel_train_phase(dev, card: str, gen):
    """The --pa_feat flagship's train step at full width through K4: K4
    against its plain version at CHECK_SCENES x 2000 points on the real
    HeadNet map and projection, the train step through make_trainer (launch
    counts, losses, ms/step, time by phase, one step two ways, a profiled
    window) and K4's timing.  Returns (record, the kernels-line entries)."""
    from alignsdf_torch.models.alignsdf import build_model

    specs = flagship_specs(pixel=True)
    model = build_model(specs, device=dev, seed=SEED)
    rec = {"check": {}}
    for scenes in CHECK_SCENES:
        phase(f"K4 vs plain ({scenes} x {specs.samples_per_scene} points, both trunks, full "
              "--pa_feat flagship width, the HeadNet map and projection of a synthetic batch, "
              "TF32 off)")
        inputs, trunks, st, _ = k4_operands(model, specs, dev, scenes)
        k4 = k4_check(inputs, trunks, st, dev, gen)
        worst = sorted(k4["grad_rel_err"].items(), key=lambda kv: -kv[1])[:4]
        print(f"K4 y max abs err {k4['y_max_abs_err']:.3e} (tolerance {K4_TOL:g}), latent "
              f"{k4['latent_max_abs_err']:.3e}; {forward_text(k4)}; gradients max err "
              f"{k4['grad_max_abs_err']:.3e} "
              f"abs, {k4['grad_max_rel_err']:.3e} of the largest (tolerance {K4_TOL:g}; worst "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst) + f"); in-image share "
              f"{k4['in_image_share']:.4f}; kept share {k4['kept_share']}; residual sign "
              f"mismatch {k4['residual_sign_mismatch']:.2e}", flush=True)
        if not (k4["y_max_abs_err"] <= K4_TOL and k4["grad_max_rel_err"] <= K4_TOL):
            fail(f"K4 disagrees with its plain version at {scenes} scenes")
        forward_verdict(k4, "K4", K4_TOL)
        if not 0.0 < k4["in_image_share"] < 1.0:
            fail(f"the in-image share {k4['in_image_share']} must lie strictly between 0 and 1, "
                 "so that the taps, the mean fallback and d(pix) all run")
        if len(k4["kept_share"]) != 8 or not all(abs(v - 0.8) <= 0.01
                                                 for v in k4["kept_share"].values()):
            fail(f"kept shares off 0.8 +- 0.01: {k4['kept_share']}")
        if not k4["residual_sign_mismatch"] <= 1e-4:
            fail("K4's residuals are not gated as the plain version's")
        rec["check"][scenes] = k4
    k4 = rec["check"][TRAIN_SCENES]

    phase(f"pixel training: {WARM_STEPS} warm-up + {TIMED_STEPS} timed steps at {TRAIN_SCENES} x "
          f"{specs.samples_per_scene} points, one step two ways, {PROFILED_STEPS} profiled steps")
    state, rec["train"] = train_phase(specs, dev, card, k4_kernel())
    del state

    phase(f"timing: K4 forward and backward per step ({TRAIN_SCENES} x "
          f"{specs.samples_per_scene} points, both trunks); F.grid_sample at the same points")
    inputs, trunks, st, (fmap, uv) = k4_operands(model, specs, dev, TRAIN_SCENES)
    rec["timing"] = k4_timing(inputs, trunks, st, fmap, uv, dev, gen, card)
    entries = []
    for name, line, err in (("fwd", 335, k4["y_max_abs_err"]),
                            ("bwd", 647, k4["grad_max_abs_err"])):
        t = rec["timing"][name]
        entries.append({
            "name": f"K4 pixel train decoder, {'forward' if name == 'fwd' else 'backward'}",
            "route": "cuda",
            "source": "alignsdf_torch/kernels/csrc/pixel_train_decoder.cu",
            "replaces": f"alignsdf_tpu/ops/decoder_train_pixel.py:{line}",
            "launches": rec["train"]["launches"][name],
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": (f"F.grid_sample bicubic {'forward' if name == 'fwd' else 'backward'}"
                             " at the step's points (the sampling step only)"),
            **({"trunk": FWD_SOURCE} if name == "fwd" else backward_entry(t)),
        })
    return rec, entries


def classifier_phase(dev, card: str, gen, mano_faces, pixel: bool = False):
    """The labelled DexYCB full model (--cls) at full width through K1 with
    2 + C rows and K2 with x_last, or with ``pixel`` (--pa_feat --cls)
    through K3 with 2 + C rows and K4 with x_last: the grid kernel against
    its plain version at C = 6, (8,) 126, the main path (run_pipelined over
    N_IMAGES images with label_out and viz), image 0's fields and logits
    against the generic path, the train kernel against its plain version
    with dx_last, the train step with the cross-entropy on, and the timing
    of both.  Returns (record, the main paths' numbers for the kernels
    line's entries)."""
    import dataclasses

    import numpy as np
    import torch

    from alignsdf_torch.inference.grid import _coords_from_linear, embed_points
    from alignsdf_torch.inference.reconstruct import Reconstructor, make_output_dirs, run_pipelined
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.models.decoder import make_decoder
    from alignsdf_torch.ops.geometry import pixel_alignment

    if pixel:
        from alignsdf_torch.kernels.pixel_grid_decoder import (
            pixel_grid_decode as grid_kernel, pixel_grid_decode_reference as grid_plain,
            pixel_projection)
        from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn as make_plan
        grid_name, train_name, classes, flag = "K3", "K4", (126,), "--pa_feat --cls"
    else:
        from alignsdf_torch.kernels.grid_decoder import (
            grid_decode as grid_kernel, grid_decode_reference as grid_plain)
        from alignsdf_torch.ops.grid_plan import make_grid_decode_fn as make_plan
        grid_name, train_name, classes, flag = "K1", "K2", (8, 126), "--cls"

    specs = flagship_specs(pixel=pixel, experiment="dexycb_140k.json", classifier=True)
    num_class = specs.network_specs.num_class
    model = build_model(specs, device=dev, seed=SEED)
    samples = synthetic_samples(gen, N_IMAGES)
    n, chunk = CUBE_DIM, 1 << 20  # the fused evaluator's runs are 2^20 points
    total = n ** 3
    origin0 = torch.full((3,), -1.0, device=dev)
    voxel0 = torch.tensor(2.0 / (n - 1), device=dev)
    rec, info = {}, {}

    def one_pass(fn, plan, origin, voxel):
        return torch.cat([fn(plan, s, min(chunk, total - s), origin, voxel)
                          for s in range(0, total, chunk)], dim=1)

    # seeded weights: shift the final biases so ~5% of the first pass is
    # inside, and scale the classifier head x40 and centre its logits over
    # that pass, so that the labels vary
    with torch.no_grad():
        model.decoder.classifier_head.weight *= 40
        first = grid_plain(make_plan(specs, 64)(scene_ctx(model, specs, samples[0], dev)).plan, 0,
                           64 ** 3, origin0, torch.tensor(2.0 / 63, device=dev))
        for row, name in ((0, "linh4"), (1, "lino4")):
            q = torch.quantile(first[row], 0.05).clamp(-0.999, 0.999)
            getattr(model.decoder, name).bias -= torch.atanh(q)
        model.decoder.classifier_head.bias -= first[2:].mean(dim=1)
    del first

    phase(f"classifier ({flag}): {grid_name} with 2 + C rows vs plain (the first {n}^3 pass of "
          f"image 0, full width, C = {', '.join(str(c) for c in (num_class, *classes))}, TF32 "
          "off)")
    ctx = scene_ctx(model, specs, samples[0], dev)
    saved = grid_kernel.launches
    rec["grid_check"] = {}
    for c in (num_class, *classes):
        cctx = ctx
        if c != num_class:  # a seeded decoder with C classes on the same scene
            cspecs = dataclasses.replace(specs, network_specs=dataclasses.replace(
                specs.network_specs, num_class=c))
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED + c)
                dec = make_decoder(cspecs.model_type, cspecs.latent_size,
                                   cspecs.point_feat_size, cspecs.encode_style,
                                   cspecs.network_specs, use_classifier=True).to(dev)
            with torch.no_grad():
                dec.classifier_head.weight *= 40
            cctx = dict(ctx, decoder=dec)
        else:
            cspecs = specs
        plan = make_plan(cspecs, n)(cctx).plan
        err = {"sdf": 0.0, "logits": 0.0}
        clear = mismatch = inside = 0
        for s in range(0, total, chunk):
            m = min(chunk, total - s)
            k = grid_kernel(plan, s, m, origin0, voxel0)
            torch.cuda.synchronize()
            with torch.no_grad():
                r = grid_plain(plan, s, m, origin0, voxel0)
            err["sdf"] = max(err["sdf"], float((k[:2] - r[:2]).abs().max()))
            err["logits"] = max(err["logits"], float((k[2:] - r[2:]).abs().max()))
            top2 = r[2:].topk(2, dim=0).values
            sel = (top2[0] - top2[1]) > 1e-5
            clear += int(sel.sum())
            mismatch += int(((k[2:].argmax(0) != r[2:].argmax(0)) & sel).sum())
            if pixel:
                inside += int(pixel_projection(plan, s, m, origin0, voxel0)[3].sum())
        labels = int(torch.unique(k[2:].argmax(0)).numel())
        share = f"; in-image share {inside / total:.4f}" if pixel else ""
        print(f"C = {c}: {2 + c} rows; {grid_name} max abs err vs plain: SDF rows "
              f"{err['sdf']:.3e}, logits {err['logits']:.3e} (tolerance {K1_TOL:g}); argmax "
              f"mismatches {mismatch} of {clear} points whose top two logits differ by > 1e-5 "
              f"({total} in all); {labels} distinct labels in the last run{share}", flush=True)
        if not (max(err.values()) <= K1_TOL and mismatch == 0 and clear > total // 2):
            fail(f"{grid_name} with {2 + c} rows disagrees with its plain version")
        if pixel and not 0 < inside < total:
            fail(f"the pass's in-image share {inside / total} must lie strictly between 0 and 1")
        rec["grid_check"][c] = {**err, "argmax_mismatch": mismatch, "clear_points": clear}
        if pixel:
            rec["grid_check"][c]["in_image_share"] = inside / total
    grid_kernel.launches = saved
    info["grid_max_abs_err"] = max(max(v["sdf"], v["logits"]) for v in rec["grid_check"].values())
    del k, r, plan

    phase(f"classifier main path ({flag}): run_pipelined with label_out and viz, {N_IMAGES} "
          f"images at cube_dim {n}")
    recon = Reconstructor(model, specs, cube_dim=n, mano_faces=mano_faces)
    expected = N_IMAGES * 2 * (-(-total // chunk))
    results = []
    with tempfile.TemporaryDirectory() as out:
        dirs = make_output_dirs(out)
        grid_kernel.launches = 0
        t0 = time.perf_counter()
        done = run_pipelined(recon, samples, dirs, label_out=True, viz=True,
                             on_done=lambda i, p: results.append((i, p)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = grid_kernel.launches
        written = sorted(os.listdir(dirs["meshes"]))
        labelled = []
        for i, pending in results:
            hand, key = pending["meshes"]["hand"], pending["sample"]["key"]
            if hand is None:
                continue
            with np.load(os.path.join(dirs["meshes"], f"{key}_hand_label.npz")) as f:
                lab = f["labels"]
            colored = os.path.isfile(os.path.join(dirs["meshes"], f"{key}_hand_color.ply"))
            if not (lab.shape == (len(hand.vertices),) and colored and lab.min() >= 0
                    and lab.max() < num_class and np.all(lab == np.round(lab))):
                fail(f"image {i}: labels {lab.shape} for {len(hand.vertices)} vertices, range "
                     f"[{lab.min()}, {lab.max()}], color PLY written {colored}")
            labelled.append({"image": i, "vertices": len(hand.vertices),
                             "labels": np.bincount(lab.astype(np.int64),
                                                   minlength=num_class).tolist()})
    print(f"images {done}, wall {wall * 1e3:.1f} ms, {grid_name} launches {launches} (expected "
          f"{expected}), meshes written {written}; per-vertex labels (counts by part) "
          f"{labelled}", flush=True)
    if done != N_IMAGES or launches != expected:
        fail(f"{grid_name} launches {launches} != expected {expected} over {done} images")
    if not labelled:
        fail("no image got a hand mesh, so no label was written")
    rec["main_path"] = {"wall_ms": wall * 1e3, "launches": launches, "meshes": written,
                        "labels": labelled, "images": []}
    info["grid_launches"] = launches
    for i, pending in results:
        host = pending["host"]
        for name in ("sdf_hand", "sdf_obj"):
            field = host[name]
            if tuple(field.shape) != (n,) * 3 or not bool(torch.isfinite(field).all()):
                fail(f"classifier image {i}: {name} has shape {tuple(field.shape)} or "
                     "non-finite values")
        t = pending["timings"]
        print(f"classifier ({flag}) image {i} [{card}]: encode {t['encode_ms']:.2f} ms, grid "
              f"{t['grid_ms']:.2f} ms (2 passes), {host_text(t)}", flush=True)
        rec["main_path"]["images"].append(t)

    # image 0's refined pass against the generic path (decode_points on
    # materialized rows; for --pa_feat the map sampled at each point's
    # projection) at 4096 grid points: the main path's fields, and the
    # logits of the grid kernel run again over that pass
    host0 = results[0][1]["host"]
    ctx = scene_ctx(model, specs, samples[0], dev)
    origin_r, voxel_r = host0["origin"].to(dev), host0["voxel"].to(dev)
    idx = torch.randint(0, total, (4096,), generator=gen).to(dev)
    pts = _coords_from_linear(idx, n, origin_r, voxel_r)
    with torch.no_grad():
        if pixel:
            lat = pixel_alignment(ctx["latent"], pts, ctx["cam_intr"], ctx["pred_root"],
                                  specs.image_size[0], specs.sdf_scale_factor)
        else:
            lat = ctx["latent"].expand(4096, -1)
        gh, go, gl = model.decode_points(torch.cat([lat, embed_points(specs, ctx, pts)], dim=1))
    saved = grid_kernel.launches
    rows = one_pass(grid_kernel, make_plan(specs, n)(ctx).plan, origin_r, voxel_r)
    grid_kernel.launches = saved
    idx_cpu = idx.cpu()
    field_err = max(float((gh[:, 0].cpu() - host0["sdf_hand"].reshape(-1)[idx_cpu]).abs().max()),
                    float((go[:, 0].cpu() - host0["sdf_obj"].reshape(-1)[idx_cpu]).abs().max()))
    logit_err = float((rows[2:, idx].T - gl).abs().max())
    print(f"image 0 vs the generic path at 4096 grid points: fields max abs err {field_err:.3e}, "
          f"logits {logit_err:.3e} (tolerance {K1_TOL:g})", flush=True)
    if not (field_err <= K1_TOL and logit_err <= K1_TOL):
        fail(f"the classifier main path disagrees with the generic path: {field_err}, "
             f"{logit_err}")
    rec["vs_generic"] = {"field_max_abs_err": field_err, "logits_max_abs_err": logit_err}
    del recon, rows

    rec["train_check"] = {}
    for scenes in CHECK_SCENES:
        phase(f"classifier ({flag}): {train_name} with x_last vs plain ({scenes} x "
              f"{specs.samples_per_scene} points, both trunks, full width, nonzero dy and "
              "dx_last, TF32 off)")
        if pixel:
            inputs, trunks, st, _ = k4_operands(model, specs, dev, scenes)
            tc = k4_check(inputs, trunks, st, dev, gen, x_last=True)
            if not 0.0 < tc["in_image_share"] < 1.0:
                fail(f"the in-image share {tc['in_image_share']} must lie strictly between 0 "
                     "and 1")
        else:
            tc = k2_check(model, specs, dev, gen, scenes, x_last=True)
        print(f"{train_name} y max abs err {tc['y_max_abs_err']:.3e}, x_last "
              f"{tc['x_last_max_abs_err']:.3e} (tolerance {K2_TOL:g}); {forward_text(tc)}; "
              f"gradients max err "
              f"{tc['grad_max_abs_err']:.3e} abs, {tc['grad_max_rel_err']:.3e} of the largest "
              f"(tolerance {K2_TOL:g}); kept share {tc['kept_share']}; residual sign mismatch "
              f"{tc['residual_sign_mismatch']:.2e}", flush=True)
        if not (tc["y_max_abs_err"] <= K2_TOL and tc["x_last_max_abs_err"] <= K2_TOL
                and tc["grad_max_rel_err"] <= K2_TOL):
            fail(f"{train_name} with x_last disagrees with its plain version at {scenes} scenes")
        forward_verdict(tc, train_name, K2_TOL)
        if not tc["residual_sign_mismatch"] <= 1e-4:
            fail(f"{train_name}'s residuals are not gated as the plain version's")
        rec["train_check"][scenes] = tc
    info["train_check"] = rec["train_check"][TRAIN_SCENES]

    # AdditionalLossStart 1: in epoch 1 the cross-entropy is on, so dx_last
    # carries its gradient into the train kernel's backward
    train_specs = dataclasses.replace(specs, additional_loss_start=1)
    phase(f"classifier training ({flag}): {WARM_STEPS} warm-up + {TIMED_STEPS} timed steps at "
          f"{TRAIN_SCENES} x {specs.samples_per_scene} points with the cross-entropy on, one step "
          f"two ways, {PROFILED_STEPS} profiled steps")
    state, rec["train"] = train_phase(train_specs, dev, card,
                                      k4_kernel() if pixel else k2_kernel())
    cls_losses = rec["train"].get("cls", [])
    if len(cls_losses) != WARM_STEPS + TIMED_STEPS or not all(
            np.isfinite(c) and c > 0 for c in cls_losses):
        fail(f"the cls loss must be finite and nonzero at every step: {cls_losses}")
    info["train_launches"] = rec["train"]["launches"]

    phase(f"classifier timing ({flag}): {grid_name} per {n}^3 pass at C = {num_class}; "
          f"{train_name} with x_last forward and backward per step ({TRAIN_SCENES} x "
          f"{specs.samples_per_scene} points, both trunks)")
    plan = make_plan(specs, n)(ctx).plan
    saved = grid_kernel.launches
    grid_runs = [cuda_ms(lambda: one_pass(grid_kernel, plan, origin0, voxel0), 1)
                 for _ in range(3)]
    grid_kernel.launches = saved
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: one_pass(grid_plain, plan, origin0, voxel0), 1)
    if pixel:
        sampled = sum(int(pixel_projection(plan, s, min(chunk, total - s), origin0, voxel0)[3]
                          .sum()) for s in range(0, total, chunk))
        flops = k3_flops(specs, total, sampled)
        nbytes = 4 * ((2 + num_class) * total + plan.flat.numel() + plan.table.numel())
    else:
        flops = k1_flops_per_point(specs) * total
        nbytes = 4 * ((2 + num_class) * total + plan.flat.numel())
    grid_ms = min(grid_runs)
    rec["grid_timing"] = {"ms": grid_ms, "runs_ms": grid_runs, "plain_ms": plain_ms,
                          **grid_bounds(flops, nbytes),
                          "tflop": flops / 1e12, "tflops": flops / grid_ms / 1e9}
    print(f"[{card}] {n}^3 pass at C = {num_class} ({2 + num_class} rows, {flops / 1e12:.3f} "
          f"TFLOP): {grid_name} " + " / ".join(f"{t:.2f}" for t in grid_runs) + f" ms (best "
          f"{flops / grid_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
          f"{bounds_text(rec['grid_timing'])}", flush=True)
    if pixel:
        inputs, trunks, st, (fmap, uv) = k4_operands(state.model, specs, dev, TRAIN_SCENES)
        rec["train_timing"] = k4_timing(inputs, trunks, st, fmap, uv, dev, gen, card, x_last=True)
    else:
        rec["train_timing"] = k2_timing(state.model, specs, dev, gen, card, x_last=True)
    info["grid_timing"], info["train_timing"] = rec["grid_timing"], rec["train_timing"]
    del state
    return rec, info


def nerf63_specs():
    """experiments/obman_30k.json with --point_size 63: its own NeRF PE
    (EncodeStyle nerf) at (63 - 3) // 6 = 10 frequencies, no MANO, twin 5x512
    trunks reading 256 + 63 = 319 columns."""
    from alignsdf_torch.config import apply_overrides, load_specs

    class Flags:
        point_size = 63

    return apply_overrides(load_specs(os.path.join(REPO, "experiments", "obman_30k.json")),
                           Flags())


def latent_in_0_specs():
    """The flagship with NetworkSpecs latent_in (0, 2): layer 0 reads [row,
    row], so K2 declines it and the step trains through K5."""
    import dataclasses

    specs = flagship_specs()
    return dataclasses.replace(specs, network_specs=dataclasses.replace(specs.network_specs,
                                                                        latent_in=(0, 2)))


def generic_macs_per_point(specs) -> int:
    """Multiply-adds of the generic decoder (K5, K6) per point at the true
    widths, every trunk: layer 0 as one product on the input row (its two
    halves summed where 0 is in latent_in), a latent_in layer's input
    [x, row], and the classifier's rows on the first trunk."""
    from alignsdf_torch.models.decoder import trunk_layer_dims
    from alignsdf_torch.ops.decoder_plan import trunk_input_widths

    ns = specs.network_specs
    widths = trunk_input_widths(specs)
    out_dim = 2 if len(widths) == 1 else 1
    total = 0
    for t, in_dim in enumerate(widths):
        shapes = trunk_layer_dims(in_dim, ns, out_dim)
        total += sum((in_dim if layer == 0 else i) * o for layer, (i, o) in enumerate(shapes))
        if t == 0 and specs.classifier_branch:
            total += shapes[-2][1] * ns.num_class
    return total


def generic_model(dev, sample):
    """(specs, model): the --point_size 63 flagship at full width, seeded,
    its NeRF PE damped and its final biases shifted on ``sample``."""
    import torch

    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.models.decoder import trunk_prefixes

    specs = nerf63_specs()
    model = build_model(specs, device=dev, seed=SEED)
    n0 = 64
    origin0 = torch.full((3,), -1.0, device=dev)
    # seeded weights hear NeRF PE's 2^9 frequency as loudly as its 2^0: at
    # 128^3 the field is noise, whose meshes took about 160 s an image of
    # host marching cubes (the host of an NVIDIA H100 80GB HBM3 at 700 W).
    # Scale each frequency level k's columns of the layers that read the row
    # (0 and latent_in) by 4^-k, towards a trained field's smoothness; the
    # kernel does the same work.
    ls, pfs = specs.latent_size, specs.point_feat_size
    damp = torch.ones(ls + pfs, device=dev)
    for k in range((pfs - 3) // 6):
        damp[ls + 3 + 6 * k:ls + 9 + 6 * k] = 4.0 ** -k
    with torch.no_grad():
        for prefix in filter(None, trunk_prefixes(model.decoder)):
            for layer in (0, *specs.network_specs.latent_in):
                getattr(model.decoder, f"{prefix}{layer}").weight_v[:, -(ls + pfs):] *= damp

    # shift the final biases (seeded weights) so ~5% of the first pass is
    # inside: the field crosses zero and meshes come out
    ctx = scene_ctx(model, specs, sample, dev)
    with torch.no_grad():
        first = [torch.cat(f) for f in zip(*[model.decoder(r)[:2] for r in generic_rows(
            specs, ctx, n0, origin0, torch.tensor(2.0 / (n0 - 1), device=dev), dev)])]
        for field, name in zip(first, ("linh4", "lino4")):
            q = torch.quantile(field[:, 0], 0.05).clamp(-0.999, 0.999)
            getattr(model.decoder, name).bias -= torch.atanh(q)
    return specs, model


def generic_phase(dev, card: str, gen, mano_faces):
    """--point_size 63 reconstruction (NeRF PE, which K1 cannot fold) at full
    width through K6, as the JAX CLI's --pallas runs it: K6 against its plain
    version over one 128^3 pass, at C = 6 and on a combined trunk, the main
    path (run_pipelined with K6 as the generic path's decode_fn), image 0's
    field against decode_points, a warm and a profiled run, and K6's time
    per pass.  Returns (record, the kernels-line entry)."""
    import dataclasses

    import torch

    from alignsdf_torch.inference.grid import _coords_from_linear, embed_points
    from alignsdf_torch.inference.reconstruct import Reconstructor, make_output_dirs, run_pipelined
    from alignsdf_torch.kernels.generic_decoder import generic_decode, generic_decode_reference
    from alignsdf_torch.models.decoder import make_decoder, separate_decoder_inputs
    from alignsdf_torch.ops.decoder_plan import make_generic_decode_fn, make_generic_plan

    samples = synthetic_samples(gen, N_IMAGES)
    specs, model = generic_model(dev, samples[0])
    n, chunk = CUBE_DIM, 1 << 18  # the generic evaluator's runs are 2^18 points
    total = n ** 3
    origin0 = torch.full((3,), -1.0, device=dev)
    voxel0 = torch.tensor(2.0 / (n - 1), device=dev)
    rec = {}

    def ctx_of(sample):
        args = [torch.as_tensor(sample[k])[None].to(dev) for k in
                ("image", "cam_intr", "mano_root", "rest_obj_corners")]
        return {"decoder": model.decoder, "latent": model.encode_scene(*args)[0]}

    def trunk_rows(rows):
        return separate_decoder_inputs(specs.latent_size, specs.encode_style, rows)

    ctx = ctx_of(samples[0])

    phase(f"K6 vs plain (one {n}^3 pass of image 0 in runs of {chunk}, --point_size 63 at full "
          "width: rows of 256 + 63, TF32 off)")
    plan = make_generic_plan(model.decoder, specs)
    saved = generic_decode.launches
    err, inside = 0.0, 0
    for rows in generic_rows(specs, ctx, n, origin0, voxel0, dev, chunk):
        k6 = generic_decode(plan, *trunk_rows(rows))
        torch.cuda.synchronize()
        ref = generic_decode_reference(plan, *trunk_rows(rows))
        err = max(err, max(float((a - b).abs().max()) for a, b in zip(k6[:2], ref[:2])))
        inside += int((ref[0] < 0).sum())
    print(f"K6 max abs err vs plain {err:.3e} over {total} points (tolerance {K6_TOL:g}); hand "
          f"inside share {inside / total:.4f}", flush=True)
    if not err <= K6_TOL:
        fail(f"K6 disagrees with its plain version: {err}")
    rec["check"] = {"max_abs_err": err, "inside_share": inside / total}

    phase(f"K6 at C = 6 with a classifier and on a combined trunk (one run of {chunk} rows)")
    rows = next(generic_rows(specs, ctx, n, origin0, voxel0, dev, chunk))
    rec["variants"] = {}
    for model_type in ("1encoder2decoder", "1encoder1decoder"):
        vspecs = dataclasses.replace(specs, model_type=model_type, classifier_branch=True)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED + 6)
            dec = make_decoder(model_type, vspecs.latent_size, vspecs.point_feat_size,
                               vspecs.encode_style, vspecs.network_specs,
                               use_classifier=True).to(dev)
        vplan = make_generic_plan(dec, vspecs)
        args = (rows,) if model_type == "1encoder1decoder" else trunk_rows(rows)
        out = generic_decode(vplan, *args)
        torch.cuda.synchronize()
        ref = generic_decode_reference(vplan, *args)
        errs = {"sdf": max(float((a - b).abs().max()) for a, b in zip(out[:2], ref[:2])),
                "logits": float((out[2] - ref[2]).abs().max())}
        print(f"{model_type} with C = 6: K6 max abs err vs plain: SDFs {errs['sdf']:.3e}, logits "
              f"{errs['logits']:.3e} (tolerance {K6_TOL:g})", flush=True)
        if not max(errs.values()) <= K6_TOL:
            fail(f"K6 ({model_type}, C = 6) disagrees with its plain version")
        rec["variants"][model_type] = errs
        err = max(err, *errs.values())
    generic_decode.launches = saved
    del rows, out, ref, k6

    phase(f"generic main path: run_pipelined with K6 as the generic path's decode_fn, "
          f"{N_IMAGES} images at cube_dim {n}")
    recon = Reconstructor(model, specs, cube_dim=n, mano_faces=mano_faces,
                          decode_fn=make_generic_decode_fn(specs))
    if recon.fused:
        fail("--point_size 63 took the fused path: K1 cannot fold NeRF PE")
    expected = N_IMAGES * 2 * (-(-total // chunk))
    results = []
    with tempfile.TemporaryDirectory() as out_dir:
        dirs = make_output_dirs(out_dir)
        generic_decode.launches = 0
        t0 = time.perf_counter()
        done = run_pipelined(recon, samples, dirs, on_done=lambda i, p: results.append((i, p)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = generic_decode.launches
        written = sorted(os.listdir(dirs["meshes"]))
    print(f"images {done}, wall {wall * 1e3:.1f} ms, K6 launches {launches} (expected "
          f"{expected}: {N_IMAGES} images x 2 passes x {-(-total // chunk)} runs), meshes written "
          f"{written}", flush=True)
    if done != N_IMAGES or launches != expected:
        fail(f"K6 launches {launches} != expected {expected} over {done} images")
    if not any(w.endswith("_hand.ply") for w in written) or not any(
            w.endswith("_obj.ply") for w in written):
        fail("the generic path wrote no hand or no object mesh")
    rec["main_path"] = {"wall_ms": wall * 1e3, "launches": launches, "meshes": written,
                        "images": []}
    for i, pending in results:
        host = pending["host"]
        for name in ("sdf_hand", "sdf_obj"):
            field = host[name]
            if tuple(field.shape) != (n,) * 3 or not bool(torch.isfinite(field).all()):
                fail(f"generic image {i}: {name} has shape {tuple(field.shape)} or non-finite "
                     "values")
        t = pending["timings"]
        print(f"generic image {i} [{card}]: encode {t['encode_ms']:.2f} ms, grid "
              f"{t['grid_ms']:.2f} ms (2 passes), {host_text(t)}", flush=True)
        rec["main_path"]["images"].append(t)

    # image 0's refined pass against decode_points at 4096 grid points
    host0 = results[0][1]["host"]
    idx = torch.randint(0, total, (4096,), generator=gen).to(dev)
    pts = _coords_from_linear(idx, n, host0["origin"].to(dev), host0["voxel"].to(dev))
    with torch.no_grad():
        gh, go, _ = model.decode_points(torch.cat([ctx["latent"].expand(4096, -1),
                                                   embed_points(specs, ctx, pts)], dim=1))
    idx_cpu = idx.cpu()
    field_err = max(float((gh[:, 0].cpu() - host0["sdf_hand"].reshape(-1)[idx_cpu]).abs().max()),
                    float((go[:, 0].cpu() - host0["sdf_obj"].reshape(-1)[idx_cpu]).abs().max()))
    print(f"image 0 K6 field vs decode_points at 4096 grid points: max abs err {field_err:.3e}",
          flush=True)
    if not field_err <= K6_TOL:
        fail(f"the generic main path disagrees with decode_points: {field_err}")
    rec["vs_decode_points_max_abs_err"] = field_err

    phase("generic: warm pipelined run, then the same run under torch.profiler")
    rec["warm"], profiled = warm_and_profiled(recon, samples, generic_decode, card, "generic ")
    if profiled is not None:
        rec["profile"] = profiled
    del recon

    phase(f"timing: K6 and plain per {n}^3 pass (the pass's rows made beforehand)")
    runs = [trunk_rows(r) for r in generic_rows(specs, ctx, n, origin0, voxel0, dev, chunk)]
    saved = generic_decode.launches
    k6_runs = [cuda_ms(lambda: [generic_decode(plan, *r) for r in runs], 1) for _ in range(3)]
    generic_decode.launches = saved
    plain_ms = cuda_ms(lambda: [generic_decode_reference(plan, *r) for r in runs], 1)
    # the plan (weight norm, the split and tiling): make_generic_decode_fn
    # builds it once while the weights stay the same, not once a run
    plan_ms = cuda_ms(lambda: make_generic_plan(model.decoder, specs), 3)
    flops = 2 * generic_macs_per_point(specs) * total
    nbytes = 4 * (total * (specs.latent_size + specs.point_feat_size) + plan.flat.numel()
                  + 2 * total)
    k6_ms = min(k6_runs)
    rec["timing"] = {"k6_ms": k6_ms, "k6_runs_ms": k6_runs, "plain_ms": plain_ms,
                     "plan_ms": plan_ms, **grid_bounds(flops, nbytes), "tflop": flops / 1e12,
                     "gbytes": nbytes / 1e9, "k6_tflops": flops / k6_ms / 1e9}
    print(f"[{card}] {n}^3 pass ({total} points, {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB): "
          "K6 " + " / ".join(f"{t:.2f}" for t in k6_runs) + f" ms (best "
          f"{flops / k6_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
          f"{bounds_text(rec['timing'])}; the plan {plan_ms:.2f} ms to build", flush=True)
    del runs
    entry = {
        "name": "K6 generic decoder (materialized rows)",
        "route": "cuda",
        "source": "alignsdf_torch/kernels/csrc/generic_decoder.cu",
        "trunk": TC_TRUNK_SOURCE,
        "replaces": "alignsdf_tpu/ops/decoder_kernel.py:139",
        "launches": launches,
        "max_abs_err": err,
        "ms": k6_ms,
        "plain_ms": plain_ms,
        "bound_ms": rec["timing"]["bound_ms"],
        "bound_by": rec["timing"]["bound_by"],
        "library_ms": None,
    }
    return rec, entry


def k5_operands(model, specs, rows):
    """[(prefix, seed, x0, ws, xs, bs)] of the trunks on materialized rows,
    detached, as ops/generic_train_plan.py hands them to K5."""
    import torch

    from alignsdf_torch.models.decoder import separate_decoder_inputs, trunk_prefixes
    from alignsdf_torch.ops.decoder_plan import trunk_input_widths
    from alignsdf_torch.ops.generic_train_plan import generic_trunk_operands

    first, second = trunk_prefixes(model.decoder)
    widths = trunk_input_widths(specs)
    inputs = ([rows] if second is None
              else separate_decoder_inputs(specs.latent_size, specs.encode_style, rows))
    out = []
    with torch.no_grad():
        for prefix, seed, width, x0 in zip((first, second), (5, 6), widths, inputs):
            ws, xs, bs = generic_trunk_operands(model.decoder, prefix, width, specs,
                                                1 if second else 2)
            out.append((prefix, seed, x0.contiguous(), ws, xs, bs))
    return out


def k5_rows(specs, dev, gen, scenes: int):
    """Materialized rows of ``scenes`` x samples_per_scene points: each
    scene's random latent repeated over its points, beside random
    embeddings."""
    import torch

    n = specs.samples_per_scene
    latent = torch.randn(scenes, specs.latent_size, generator=gen) * 0.5
    emb = torch.randn(scenes * n, specs.point_feat_size, generator=gen) * 0.5
    return torch.cat([latent.repeat_interleave(n, dim=0), emb], dim=1).to(dev)


def k5_check(model, specs, dev, gen, scenes: int):
    """K5 forward and backward on both trunks against their plain versions
    on the same card, at scenes x 2000 materialized rows, the first trunk's
    backward with a random dx_last."""
    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder

    st = make_generic_train_decoder(specs).statics
    trunks = k5_operands(model, specs, k5_rows(specs, dev, gen, scenes))
    return trunk_check(k5_kernel(), trunks, st, dev, gen, True)


def k5_kernel() -> TrainKernel:
    from alignsdf_torch.kernels.generic_train_decoder import (
        generic_train_decode, generic_train_decode_backward,
        generic_train_decode_backward_reference, generic_train_decode_forward,
        generic_train_decode_reference, pack_generic_trunk)
    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder

    def nudged(x0, *rest):
        return generic_train_decode_reference(x0 * NUDGE, *rest)

    # K2's two-ways bound holds: at 64 x 2000 on an NVIDIA H100 80GB HBM3 at
    # 700 W the two ways read 1.2e-4 and 2.9e-4 of the largest gradient
    # against floors of 7.5e-4 and 6.9e-4 (the nudge scales the whole input
    # row, the latent's columns included, so the floor sits above K2's)
    return TrainKernel("K5", generic_train_decode, generic_train_decode_backward, 2,
                       make_generic_train_decoder, generic_train_decode_reference, nudged,
                       K5_FWD_KERNELS, K5_BWD_KERNELS, TWO_WAYS_GRAD_RTOL, pack_generic_trunk,
                       generic_train_decode_forward, generic_train_decode_backward_reference)


def k5_timing(model, specs, dev, gen, card):
    """K5 forward and backward per step (both trunks at TRAIN_SCENES x 2000
    materialized rows, as the main path calls them: no dx_last) against
    their plain versions and bounds; the bounds count layer 0 as the one
    product the kernel runs (both halves of its weight summed)."""
    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder

    st = make_generic_train_decoder(specs).statics
    trunks = k5_operands(model, specs, k5_rows(specs, dev, gen, TRAIN_SCENES))
    return trunk_timing(k5_kernel(), trunks, st, dev, gen, card, False)


def generic_train_phase(dev, card: str, gen):
    """The flagship with latent_in (0, 2) at full width through K5: K5
    against its plain version at CHECK_SCENES x 2000 rows, the train step
    through make_trainer (launch counts, losses, ms/step, one step two ways,
    a profiled window), K5's timing, and the same model's K1 field (layer
    0's fold of both halves) against decode_points.  Returns (record, the
    kernels-line entries)."""
    import torch

    from alignsdf_torch.inference.grid import _coords_from_linear, embed_points
    from alignsdf_torch.kernels.grid_decoder import grid_decode
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
    from alignsdf_torch.training.train_step import make_train_step, train_decoder_kind

    specs = latent_in_0_specs()
    kind = train_decoder_kind(make_train_step(specs).decode)
    if kind != "materialized inputs (K5)":
        fail(f"latent_in (0, 2) routed to {kind}, not K5")
    model = build_model(specs, device=dev, seed=SEED)
    rec = {"check": {}, "check_combined": {}}
    # both model types: the twin trunks (rows of 262: the 256 latent columns
    # on the tensor cores, 6 on the CUDA cores) and the combined trunk (265,
    # two outputs)
    combined = dataclasses.replace(specs, model_type="1encoder1decoder")
    for label, mspecs, mmodel, key in (
            ("both trunks", specs, model, "check"),
            ("the combined trunk", combined, build_model(combined, device=dev, seed=SEED),
             "check_combined")):
        for scenes in CHECK_SCENES:
            phase(f"K5 vs plain ({scenes} x {specs.samples_per_scene} rows of "
                  f"{specs.latent_size} + {6 if mspecs is specs else 9}, {label}, the flagship "
                  "with latent_in (0, 2) at full width, nonzero dy and dx_last, TF32 off)")
            k5 = k5_check(mmodel, mspecs, dev, gen, scenes)
            print(f"K5 y max abs err {k5['y_max_abs_err']:.3e}, x_last "
                  f"{k5['x_last_max_abs_err']:.3e} (tolerance {K5_TOL:g}); {forward_text(k5)}; "
                  f"gradients max err {k5['grad_max_abs_err']:.3e} abs, "
                  f"{k5['grad_max_rel_err']:.3e} of the largest (d(x0) "
                  f"{k5['d_input_max_rel_err']:.3e}), {k5['grad_f64_max_rel_err']:.3e} of "
                  f"float64's (tolerance {K5_TOL:g}); kept share {k5['kept_share']}; residual sign mismatch "
                  f"{k5['residual_sign_mismatch']:.2e}", flush=True)
            if not (k5["y_max_abs_err"] <= K5_TOL and k5["x_last_max_abs_err"] <= K5_TOL
                    and k5["grad_max_rel_err"] <= K5_TOL and k5["grad_f64_max_rel_err"] <= K5_TOL):
                fail(f"K5 disagrees with its plain version at {scenes} scenes ({label})")
            forward_verdict(k5, "K5", K5_TOL)
            n_dropout = 4 * (2 if mspecs is specs else 1)
            if len(k5["kept_share"]) != n_dropout or not all(
                    abs(v - 0.8) <= 0.01 for v in k5["kept_share"].values()):
                fail(f"kept shares off 0.8 +- 0.01: {k5['kept_share']}")
            if not k5["residual_sign_mismatch"] <= 1e-4:
                fail("K5's residuals are not gated as the plain version's")
            rec[key][scenes] = k5
    k5 = rec["check"][TRAIN_SCENES]

    phase(f"generic training (latent_in (0, 2)): {WARM_STEPS} warm-up + {TIMED_STEPS} timed steps "
          f"at {TRAIN_SCENES} x {specs.samples_per_scene} points, one step two ways, "
          f"{PROFILED_STEPS} profiled steps")
    state, rec["train"] = train_phase(specs, dev, card, k5_kernel())

    phase(f"timing: K5 forward and backward per step ({TRAIN_SCENES} x "
          f"{specs.samples_per_scene} rows, both trunks)")
    rec["timing"] = k5_timing(state.model, specs, dev, gen, card)

    phase("the trained latent_in (0, 2) model's K1 field (layer 0's fold of both halves) vs "
          "decode_points at 4096 points of a 128^3 pass")
    ctx = scene_ctx(state.model, specs, synthetic_samples(gen, 1)[0], dev)
    n, total = CUBE_DIM, CUBE_DIM ** 3
    origin, voxel = torch.full((3,), -1.0, device=dev), torch.tensor(2.0 / (n - 1), device=dev)
    plan = make_grid_decode_fn(specs, n)(ctx).plan
    saved = grid_decode.launches
    field = torch.cat([grid_decode(plan, s, min(1 << 20, total - s), origin, voxel)
                       for s in range(0, total, 1 << 20)], dim=1)
    grid_decode.launches = saved
    idx = torch.randint(0, total, (4096,), generator=gen).to(dev)
    pts = _coords_from_linear(idx, n, origin, voxel)
    with torch.no_grad():
        gh, go, _ = state.model.decode_points(torch.cat([ctx["latent"].expand(4096, -1),
                                                         embed_points(specs, ctx, pts)], dim=1))
    fold_err = max(float((gh[:, 0] - field[0, idx]).abs().max()),
                   float((go[:, 0] - field[1, idx]).abs().max()))
    print(f"K1 field vs decode_points: max abs err {fold_err:.3e} (tolerance {K1_TOL:g})",
          flush=True)
    if not fold_err <= K1_TOL:
        fail(f"K1 disagrees with decode_points at latent_in (0, 2): {fold_err}")
    rec["k1_fold_max_abs_err"] = fold_err
    del state, field

    entries = []
    for name, line, err in (("fwd", 142, max(k5["y_max_abs_err"], k5["x_last_max_abs_err"])),
                            ("bwd", 286, k5["grad_max_abs_err"])):
        t = rec["timing"][name]
        entries.append({
            "name": f"K5 generic train decoder, {'forward' if name == 'fwd' else 'backward'}",
            "route": "cuda",
            "source": "alignsdf_torch/kernels/csrc/generic_train_decoder.cu",
            "replaces": f"alignsdf_tpu/ops/decoder_train_kernel.py:{line}",
            "launches": rec["train"]["launches"][name],
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            **({"trunk": FWD_SOURCE} if name == "fwd" else backward_entry(t)),
        })
    return rec, entries


def k7_input(shape, dev, seed: int, fmt):
    """A post-ReLU stem activation with ties, in memory format ``fmt``: ReLU
    of a normal draw (most of it zero), then per image a flat positive
    block, as a constant image region gives, and a zeroed row (a zero run)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=gen, device=dev) - 0.5)
    n, _, h, w = shape
    for i in range(n):
        r, c = 8 + (7 * i) % (h // 2), 4 + (11 * i) % (w // 2)
        x[i, :, r:r + h // 4, c:c + w // 3] = 0.25 + 0.01 * (i % 7)
        x[i, :, (3 * i) % h, :] = 0.0
    return x.contiguous(memory_format=fmt)


def k7_phase(dev, card: str, dtype=None, shapes=None):
    """K7 against its plain version at the train, serving and odd shapes
    (or ``shapes``), in the channels-last layout the encoder's stem gives
    and in NCHW, in float32 (or ``dtype``, bf16: the inputs rounded): the
    forward and the backward bit for bit (the forward also equal to
    F.max_pool2d's); the share of positions where K7's gradient differs from
    F.max_pool2d's (information); in channels last at the K7_TIMED shapes,
    the times against the bound and F.max_pool2d's forward and backward (in
    the same dtype).  The comparison launches are not the main path's: the
    counts are restored."""
    import torch
    from torch.nn import functional as F

    from alignsdf_torch.kernels.maxpool import (maxpool_backward, maxpool_backward_reference,
                                                maxpool_forward, maxpool_reference)

    dtype = dtype or torch.float32
    size = 2 if dtype == torch.bfloat16 else 4
    saved = (maxpool_forward.launches, maxpool_backward.launches, maxpool_forward.bf16_launches,
             maxpool_backward.bf16_launches)
    rec = {}
    for label, shape in (shapes or K7_SHAPES).items():
        for fmt in (torch.channels_last, torch.contiguous_format):
            layout = "channels last" if fmt == torch.channels_last else "NCHW"
            x = k7_input(shape, dev, SEED, fmt).to(dtype)
            y = maxpool_forward(x)
            y_plain = maxpool_reference(x)
            y_lib, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
            dy = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 1),
                             device=dev).to(dtype).contiguous(memory_format=fmt)
            dx = maxpool_backward(x, y, dy)
            dx_plain = maxpool_backward_reference(x, y_plain, dy)

            def lib_bwd():
                return torch.ops.aten.max_pool2d_with_indices_backward(
                    dy, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)

            dx_lib = lib_bwd()
            torch.cuda.synchronize()
            fwd_equal = bool(torch.equal(y, y_plain)) and bool(torch.equal(y, y_lib))
            fwd_err = float((y - y_plain).abs().max())
            grad_equal = bool(torch.equal(dx, dx_plain))
            grad_err = float((dx - dx_plain).abs().max())
            tie_share = float((dx != dx_lib).float().mean())
            print(f"K7{' bf16' if size == 2 else ''} at {label} shape {shape}, {layout}: forward "
                  f"equal to the plain version "
                  f"and to F.max_pool2d: {fwd_equal}; backward equal to the plain version: "
                  f"{grad_equal} (max abs err {grad_err:.3e}); positions where K7's gradient "
                  f"differs from F.max_pool2d's: {tie_share:.4f} (information: the tie routing "
                  f"differs); input zero share {float((x == 0).float().mean()):.3f}", flush=True)
            if not fwd_equal:
                fail(f"K7's forward differs from its plain version or F.max_pool2d at {label}")
            if not grad_equal:
                fail(f"K7's backward differs from its plain version at {label}, {layout}: "
                     f"{grad_err}")
            if not tie_share > 0:
                fail(f"the {label} input has no tie that routes differently: the check is blind")
            entry = rec.setdefault(label, {"shape": shape, "fwd_max_abs_err": 0.0,
                                           "grad_max_abs_err": 0.0, "layouts": {}})
            entry["fwd_max_abs_err"] = max(entry["fwd_max_abs_err"], fwd_err)
            entry["grad_max_abs_err"] = max(entry["grad_max_abs_err"], grad_err)
            entry["layouts"][layout] = {"forward_equal": fwd_equal, "grad_equal": grad_equal,
                                        "grad_max_abs_err": grad_err,
                                        "grad_differs_from_max_pool2d_share": tie_share}
            if fmt == torch.channels_last and label in K7_TIMED:  # the main path's layout
                reps = 50 if label == "train" else 200
                in_bytes, out_bytes = size * x.numel(), size * y.numel()
                times = {
                    "fwd": {"ms": cuda_ms(lambda: maxpool_forward(x), reps),
                            "plain_ms": cuda_ms(lambda: maxpool_reference(x), reps),
                            "library_ms": cuda_ms(lambda: F.max_pool2d(x, 3, 2, 1), reps),
                            "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3},
                    "bwd": {"ms": cuda_ms(lambda: maxpool_backward(x, y, dy), reps),
                            "plain_ms": cuda_ms(lambda: maxpool_backward_reference(x, y, dy),
                                                reps),
                            "library_ms": cuda_ms(lib_bwd, reps),
                            "bound_ms": 2 * (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3}}
                for name, t in times.items():
                    t["bound_by"] = "bytes"
                    t["bound_share"] = t["bound_ms"] / t["ms"]
                    print(f"[{card}] K7{' bf16' if size == 2 else ''} {name} at {label} {shape}, "
                          f"{layout}: {t['ms']:.4f} ms, "
                          f"{t['bound_share']:.1%} of the bound {t['bound_ms']:.4f} ms (bytes at "
                          f"{HBM_BYTES_PER_S / 1e12:g} TB/s), plain {t['plain_ms']:.4f} ms, "
                          f"F.max_pool2d{' backward' if name == 'bwd' else ''} "
                          f"{t['library_ms']:.4f} ms", flush=True)
                entry["timing"] = times
            del x, y, y_plain, y_lib, idx, dy, dx, dx_plain, dx_lib
    (maxpool_forward.launches, maxpool_backward.launches, maxpool_forward.bf16_launches,
     maxpool_backward.bf16_launches) = saved
    return rec


def k7_serving_check(model, specs, sample, dev):
    """Serving with the switch on: image 0 encoded with the stem pool through
    K7 and through F.max_pool2d; the stem pool outputs equal, the latents
    within 1e-6.  Returns K7's forward launches of the switch-on encode."""
    import torch
    from torch.nn import functional as F

    from alignsdf_torch.kernels.maxpool import maxpool_forward, maxpool_k3s2p1
    from alignsdf_torch.models import resnet
    from alignsdf_torch.models.alignsdf import normalize_image_on_device

    enc = model.encoder
    with torch.no_grad():
        x = normalize_image_on_device(torch.as_tensor(sample["image"])[None].to(dev))
        stem = torch.relu(enc.bn1(enc.conv1(x.permute(0, 3, 1, 2))))
        saved = maxpool_forward.launches
        pool_equal = bool(torch.equal(maxpool_k3s2p1(stem), F.max_pool2d(stem, 3, 2, 1)))
        maxpool_forward.launches = saved
        off = scene_ctx(model, specs, sample, dev)["latent"]
        resnet.KERNEL_POOL = True
        try:
            maxpool_forward.launches = 0
            on = scene_ctx(model, specs, sample, dev)["latent"]
            torch.cuda.synchronize()
            launches = maxpool_forward.launches
        finally:
            resnet.KERNEL_POOL = False
    err = float((on - off).abs().max())
    print(f"serving with the stem pool through K7: stem pool output equal to F.max_pool2d's: "
          f"{pool_equal}; latent max abs err {err:.3e} (tolerance 1e-6); K7 forward launches "
          f"{launches}", flush=True)
    if not (pool_equal and err <= 1e-6 and launches == 1):
        fail("serving with the K7 switch on disagrees with the default pool or skipped K7")
    return {"stem_pool_equal": pool_equal, "latent_max_abs_err": err, "launches": launches}


class _PlainPool:
    """The plain separable pool as a stem pool on the card (forward and
    backward in PyTorch, outputs in x's layout as K7's), for one step two
    ways; ``nudge`` scales its input by about one rounding step, to show
    how far such a perturbation moves the step's gradients.  Scaling keeps
    every tie and may make new ones; ``ties_made`` is the share of input
    positions whose routing it changed."""

    def __init__(self, nudge: float = 1.0):
        import torch

        from alignsdf_torch.kernels.maxpool import maxpool_backward_reference, maxpool_reference

        pool = self
        self.ties_made = 0.0

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                xs = x * nudge
                y = maxpool_reference(xs)
                if nudge != 1.0:
                    ones = torch.ones_like(y)
                    moved = (maxpool_backward_reference(xs, y, ones)
                             != maxpool_backward_reference(x, maxpool_reference(x), ones))
                    pool.ties_made = float(moved.float().mean())
                ctx.save_for_backward(xs, y)
                return y

            @staticmethod
            def backward(ctx, dy):
                xs, y = ctx.saved_tensors
                return maxpool_backward_reference(xs, y, dy) * nudge

        self.fn = Fn

    def __call__(self, x):
        return self.fn.apply(x)


def steady_feed(specs, state, step, gen, dev, card: str, tmp: str, synthetic: dict) -> dict:
    """Steps from disk past the loader's start-up: one epoch over an LMDB
    dataset of STEADY_SCENES scenes, each step's wall time on the host
    clock, the steps after the first STEADY_SKIP summed, STEADY_PROFILED of
    them profiled for the idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignsdf_torch.cli import train as train_cli
    from alignsdf_torch.data.synthetic import write_synthetic_lmdb
    from alignsdf_torch.training.train_step import batch_to_device, draw_seed

    t0 = time.perf_counter()
    root = write_synthetic_lmdb(os.path.join(tmp, "steady"),
                                [f"{i:08d}" for i in range(STEADY_SCENES)], image_hw=256)
    write_s = time.perf_counter() - t0
    loader = train_cli.make_loader(specs, root)
    loader.set_epoch(1)
    state.epoch = 1
    step_s, prof, prof_wall = [], None, None
    torch.cuda.synchronize()
    t_last = time.perf_counter()
    for i, batch in enumerate(loader):
        if i == STEADY_SKIP:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = t_last
        step(state, batch_to_device(batch, dev), draw_seed(gen))
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_s.append(t - t_last)
        t_last = t
        if i == STEADY_SKIP + STEADY_PROFILED - 1:
            prof.__exit__(None, None, None)
            prof_wall = t - t_prof
    n = len(step_s)
    if n != STEADY_SCENES // TRAIN_SCENES or prof_wall is None:
        fail(f"steady feed: {n} steps from a dataset of {STEADY_SCENES} scenes")
    late = np.array(step_s[STEADY_SKIP:])
    ms = float(late.mean()) * 1e3
    rec = {"write_s": write_s, "steps": n, "first_steps_ms": [v * 1e3 for v in step_s[:STEADY_SKIP]],
           "step_ms": ms, "step_ms_median": float(np.median(late)) * 1e3,
           "step_ms_min_max": [float(late.min()) * 1e3, float(late.max()) * 1e3],
           "scenes_per_s": TRAIN_SCENES / ms * 1e3, "synthetic_step_ms": synthetic["step_ms"]}
    summary = profile_summary(prof, prof_wall)
    if summary is not None:
        busy, share, _ = summary
        rec["profile"] = {"step_wall_ms": prof_wall * 1e3 / STEADY_PROFILED,
                          "device_busy_ms": busy / STEADY_PROFILED, "idle_share": 1 - share}
    print(f"[{card}] from disk, steady: {STEADY_SCENES} scenes written in {write_s:.2f} s; one "
          f"epoch of {n} steps, the first {STEADY_SKIP} (the loader's start-up) "
          + ", ".join(f"{v:.1f}" for v in rec["first_steps_ms"])
          + f" ms, then {ms:.2f} ms/step on the host clock (median {rec['step_ms_median']:.2f}, "
          f"{rec['step_ms_min_max'][0]:.2f}-{rec['step_ms_min_max'][1]:.2f}; "
          f"{rec['scenes_per_s']:.2f} scenes/s) against the synthetic flagship's "
          f"{synthetic['step_ms']:.2f} ms/step; "
          + (f"{STEADY_PROFILED} profiled steps: device busy "
             f"{rec['profile']['device_busy_ms']:.2f} ms a step, idle share "
             f"{rec['profile']['idle_share']:.3f}" if summary is not None else
             "profile: not measured (no device events)"), flush=True)
    return rec


def dataset_phase(dev, card: str, synthetic: dict):
    """The slice's path: training from an LMDB dataset on disk through the
    train CLI's epoch loop with the stem pool through K7 (see the module
    docstring, phase 14)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignsdf_torch.cli import train as train_cli
    from alignsdf_torch.data.synthetic import write_synthetic_lmdb
    from alignsdf_torch.kernels import maxpool as k7
    from alignsdf_torch.models import resnet
    from alignsdf_torch.training import checkpoints as ckpt
    from alignsdf_torch.training.train_state import TrainState, learning_rate_for_epoch
    from alignsdf_torch.training.train_step import batch_to_device, draw_seed

    rec = {}
    flags = ["--mano", "--obj_pose", "--encode", "both", "--point_size", "9", "--device", dev.type]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        keys = [f"{i:08d}" for i in range(DATASET_SCENES)]
        root = write_synthetic_lmdb(tmp, keys, image_hw=256)
        rec["write_s"] = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        print(f"wrote {DATASET_SCENES} scenes (256x256 raw RGB, 20000 x 6 SDF rows a branch) as "
              f"five LMDBs, {size / 1e6:.1f} MB, in {rec['write_s']:.2f} s", flush=True)

        # the spec: the flagship JSON with TrainSplit emptied (every key of the
        # LMDB), latest and the losses logged every epoch and step, and Resume
        # naming a healthy init (the init guard's draw, saved), so that the
        # CLI's K7 launches are its steps' alone
        with open(os.path.join(REPO, "experiments", "obman_30k.json")) as f:
            raw = json.load(f)
        state0, _ = train_cli.make_trainer(flagship_specs(), dev, seed=SEED, init_guard=True)
        resume = os.path.join(tmp, "init.pth")
        torch.save({"epoch": 0, "model_state_dict": state0.model.state_dict()}, resume)
        del state0
        raw.update(TrainSplit="", LogFrequency=1, LogFrequencyStep=1, Resume=resume,
                   ScenesPerBatch=TRAIN_SCENES)
        specs = flagship_specs(raw=raw)
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(raw, f)
        out = os.path.join(tmp, "outputs")
        steps_per_epoch = DATASET_SCENES // TRAIN_SCENES
        k2 = k2_kernel()

        def run_cli(extra, epochs):
            """(wall s, K7's launches, K2's launches) of one cli.train run."""
            k7.maxpool_forward.launches = k7.maxpool_backward.launches = 0
            k2.fwd.launches = k2.bwd.launches = 0
            t0 = time.perf_counter()
            train_cli.main(["-e", spec_path, *flags, "--data_root", root, "--output_root", out,
                            "--epoch", str(epochs), *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return (wall, {"fwd": k7.maxpool_forward.launches, "bwd": k7.maxpool_backward.launches},
                    {"fwd": k2.fwd.launches, "bwd": k2.bwd.launches})

        resnet.KERNEL_POOL = True
        try:
            phase(f"dataset training: cli.train over {DATASET_SCENES} scenes from disk, 2 epochs "
                  "with the stem pool through K7, then --continue to epoch 3")
            runs = {}
            for label, extra, epochs in (("epochs 1-2", [], 2), ("resume to 3", None, 3)):
                if extra is None:  # --epoch renames the experiment: continue from the first
                    extra = ["--continue", exp_dirs["epochs 1-2"]]
                wall, launches, k2_launches = run_cli(extra, epochs)
                exp_dir = os.path.join(
                    out, dataclasses.replace(specs, num_epochs=epochs).experiment_name())
                runs[label] = (wall, launches, k2_launches, exp_dir)
                exp_dirs = {k: v[3] for k, v in runs.items()}
            rec["cli"] = {}
            for label, (wall, launches, k2_launches, exp_dir) in runs.items():
                with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
                    lines = [json.loads(line) for line in f]
                steps = [ln for ln in lines if "step" in ln]
                epochs = [ln for ln in lines if "lr" in ln]
                first = 1 if label == "epochs 1-2" else 3
                saved = torch.load(os.path.join(exp_dir, ckpt.MODEL_DIR, "latest.pth"),
                                   map_location="cpu", weights_only=False)["epoch"]
                want_epochs = list(range(first, 3 if first == 1 else 4))
                print(f"{label}: {wall:.2f} s, K7 launches {launches}, K2 launches {k2_launches} "
                      f"({len(steps)} steps), "
                      f"epochs logged {[e['epoch'] for e in epochs]}, lr "
                      f"{[e['lr'] for e in epochs]}, latest.pth at epoch {saved}; total loss "
                      + ", ".join(f"{s['total']:.5f}" for s in steps), flush=True)
                if [e["epoch"] for e in epochs] != want_epochs:
                    fail(f"{label}: epochs {[e['epoch'] for e in epochs]} != {want_epochs}")
                if len(steps) != steps_per_epoch * len(want_epochs):
                    fail(f"{label}: {len(steps)} step lines")
                if launches != {"fwd": len(steps), "bwd": len(steps)}:
                    fail(f"{label}: K7 launches {launches} != the {len(steps)} steps")
                want_k2 = k2.per_step * len(steps)
                if k2_launches != {"fwd": want_k2, "bwd": want_k2}:
                    fail(f"{label}: K2 launches {k2_launches} != {k2.per_step} a step")
                if not all(np.isfinite(v) for s in steps for k, v in s.items()):
                    fail(f"{label}: a non-finite loss")
                if any(e["lr"] != learning_rate_for_epoch(specs, e["epoch"]) for e in epochs):
                    fail(f"{label}: the LR does not follow the schedule")
                if saved != want_epochs[-1]:
                    fail(f"{label}: latest.pth holds epoch {saved}")
                rec["cli"][label] = {"wall_s": wall, "launches": launches,
                                     "k2_launches": k2_launches,
                                     "totals": [s["total"] for s in steps],
                                     "epoch_time_s": [e["epoch_time_s"] for e in epochs]}
            rec["launches"], rec["k2_launches"] = (
                {k: sum(r[key][k] for r in rec["cli"].values()) for k in ("fwd", "bwd")}
                for key in ("launches", "k2_launches"))

            phase("dataset training: timed and profiled steps from disk, one step two ways "
                  "on a batch with rotated black corners")
            state, step = train_cli.make_trainer(specs, dev, seed=SEED, init_guard=False)
            ckpt.warm_start(state, resume)
            loader = train_cli.make_loader(specs, root)
            gen = torch.Generator().manual_seed(SEED)
            saved_counts = (k7.maxpool_forward.launches, k7.maxpool_backward.launches,
                            k2.fwd.launches, k2.bwd.launches)

            def epoch_steps(epoch):
                loader.set_epoch(epoch)
                state.epoch = epoch
                for batch in loader:
                    step(state, batch_to_device(batch, dev), draw_seed(gen))

            epoch_steps(1)  # warm: cuDNN's choices, the loader's first pass
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for epoch in (2, 3, 4):
                epoch_steps(epoch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / (3 * steps_per_epoch)
            loader.set_epoch(5)
            t0 = time.perf_counter()
            n_batches = sum(1 for _ in loader)
            load_ms = (time.perf_counter() - t0) / n_batches * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                epoch_steps(6)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            summary = profile_summary(prof, prof_wall)
            syn = synthetic["step_ms"]
            print(f"[{card}] from disk at epoch start-up: {wall * 1e3:.2f} ms/step on the host "
                  f"clock ({TRAIN_SCENES / wall:.2f} scenes/s) over 3 epochs of {steps_per_epoch} "
                  f"steps, against the synthetic flagship's {syn:.2f} ms/step "
                  f"({TRAIN_SCENES / syn * 1e3:.2f} scenes/s, a batch already on the card); "
                  f"the loader alone (DataLoaderThreads {specs.data_loader_threads}) "
                  f"{load_ms:.1f} ms a batch", flush=True)
            rec["timing"] = {"step_ms": wall * 1e3, "scenes_per_s": TRAIN_SCENES / wall,
                             "synthetic_step_ms": syn, "loader_ms_per_batch": load_ms}
            if summary is None:
                print("dataset profile: not measured (no device events)", flush=True)
            else:
                busy, share, by_kernel = summary
                k7_ms = {n: sum(v for k, v in by_kernel.items() if names[0] in k)
                         / steps_per_epoch
                         for n, names in (("fwd", K7_FWD_KERNELS), ("bwd", K7_BWD_KERNELS))}
                print(f"[{card}] {steps_per_epoch} profiled steps from disk (one epoch), "
                      f"{prof_wall * 1e3 / steps_per_epoch:.2f} ms each: device busy "
                      f"{busy / steps_per_epoch:.2f} ms a step, idle share {1 - share:.3f}; "
                      f"K7 fwd {k7_ms['fwd']:.3f} ms, bwd {k7_ms['bwd']:.3f} ms a step",
                      flush=True)
                rec["profile"] = {"step_wall_ms": prof_wall * 1e3 / steps_per_epoch,
                                  "device_busy_ms": busy / steps_per_epoch,
                                  "idle_share": 1 - share, "k7_ms": k7_ms}

            # one step two ways on a batch with rotated images: K7 against
            # the plain separable pool, everything else equal, both through
            # the main path's decoder (K2).  K7 and its plain version agree
            # bit for bit, and both steps give the same cuDNN kernels the
            # same layout, so the steps differ only by the order of K2's
            # atomic sums, whose run-to-run spread (the K7 step twice) is
            # the comparison's rounding floor.  Printed beside: the step
            # with the pool's input scaled by 1 + 2^-23, and F.max_pool2d's.
            loader.set_epoch(7)
            batch = next(iter(loader))
            img = batch["image"]
            black = [i for i in range(len(img)) if not img[i, :8, :8].any()]
            print(f"two ways batch: {len(black)} of {len(img)} images have black corners",
                  flush=True)
            if not black:
                fail("no image of the batch was rotated: the two ways would see no tie")
            batch = batch_to_device(batch, dev)
            model = state.model

            def twin_state():
                twin = copy.deepcopy(model)
                opt = type(state.optimizer)(twin.parameters(), **state.optimizer.defaults)
                opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
                return TrainState(twin, opt, state.epoch)

            seed = draw_seed(gen)
            nudged = _PlainPool(NUDGE)
            # name: stem pool (None for K7, False for F.max_pool2d, else a plain pool)
            pools = {"kernel": None, "plain": _PlainPool(), "again": None, "nudge": nudged,
                     "default": False}
            states = {name: twin_state() for name in pools}
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
            kernel_pool = k7.maxpool_k3s2p1
            losses = {}
            try:
                for name, pool in pools.items():
                    resnet.KERNEL_POOL = pool is not False
                    if pool:
                        k7.maxpool_k3s2p1 = pool
                    try:
                        losses[name] = {k: float(v) for k, v in
                                        step(states[name], batch, seed).items()}
                    finally:
                        k7.maxpool_k3s2p1 = kernel_pool
                        resnet.KERNEL_POOL = True
            finally:
                torch.backends.cudnn.deterministic = False
                torch.use_deterministic_algorithms(False)
            (k7.maxpool_forward.launches, k7.maxpool_backward.launches,
             k2.fwd.launches, k2.bwd.launches) = saved_counts

            def grad_err(name, ref="plain"):
                """(max over parameters of the max abs gradient error over the
                parameter's largest entry, the 3 worst parameters)."""
                base = dict(states[ref].model.named_parameters())
                errs = {k: float((p.grad - base[k].grad).abs().max())
                        / (float(base[k].grad.abs().max()) + 1e-30)
                        for k, p in states[name].model.named_parameters()}
                worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
                return worst[0][1], worst

            lk, lp = losses["kernel"], losses["plain"]
            loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
            errs = {"kernel": grad_err("kernel"), "floor": grad_err("again", "kernel"),
                    "nudge": grad_err("nudge"), "default": grad_err("default")}
            print(f"one step two ways (K7 vs the plain separable pool, both through K2) on "
                  f"{len(black)} rotated images: losses max rel err {loss_rel:.3e} (tolerance "
                  f"{TWO_WAYS_LOSS_RTOL:g}); gradients max err of the largest "
                  f"{errs['kernel'][0]:.3e} (tolerance {TWO_WAYS_GRAD_RTOL:g}); the rounding "
                  f"floor, the K7 step against itself (K2's atomic sums): {errs['floor'][0]:.3e}; "
                  f"information: the plain step with the pool's input scaled by 1 + 2^-23 "
                  f"(routing changed at {nudged.ties_made:.3e} of the positions) "
                  f"{errs['nudge'][0]:.3e}, F.max_pool2d's step (its tie routing differs) "
                  f"{errs['default'][0]:.3e}", flush=True)
            for name, (_, worst) in errs.items():
                print(f"  worst parameters, {name}: "
                      + ", ".join(f"{k} {v:.2e}" for k, v in worst), flush=True)
            if not (loss_rel <= TWO_WAYS_LOSS_RTOL and errs["kernel"][0] <= TWO_WAYS_GRAD_RTOL):
                fail("the step through K7 and through the plain separable pool disagree")
            rec["two_ways"] = {"images_with_black_corners": len(black),
                               "loss_max_rel_err": loss_rel,
                               "nudge_ties_made_share": nudged.ties_made,
                               **{f"{name}_grad_max_rel_err": e[0] for name, e in errs.items()},
                               "worst": {name: e[1] for name, e in errs.items()}}

            rec["steady"] = steady_feed(specs, state, step, gen, dev, card, tmp, synthetic)
        finally:
            resnet.KERNEL_POOL = False
    return rec


def geometric_phase(dev, card: str):
    """Phase 16, the proof of learning, then evaluation (see the module
    docstring): the geometric dataset, the flagship trained on it through
    cli/train.make_trainer's step (K2), reconstructed through
    cli.reconstruct.main (K1) at 128^3, with --eval_mode and at 256^3, and
    scored through cli.evaluate.main."""
    import numpy as np
    import torch

    from alignsdf_torch.cli import evaluate as evaluate_cli
    from alignsdf_torch.cli import reconstruct as reconstruct_cli
    from alignsdf_torch.cli import train as train_cli
    from alignsdf_torch.config import specs_to_dict
    from alignsdf_torch.data import make_train_dataset
    from alignsdf_torch.data.dataset import ImagesDataset, collate, to_train_batch
    from alignsdf_torch.data.synthetic import write_geometric_lmdb
    from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference
    from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
    from alignsdf_torch.training import checkpoints as ckpt
    from alignsdf_torch.training.train_step import COND_KEYS, batch_to_device, draw_seed

    rec = {"card": card}
    keys = [f"{i:08d}" for i in range(GEO_SCENES)]
    k2 = k2_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        phase(f"geometric: {GEO_SCENES} scenes written (train LMDBs, test meta and GT meshes, "
              "the samples npz)")
        t0 = time.perf_counter()
        data_root = os.path.join(tmp, "data")
        paths = write_geometric_lmdb(data_root, keys, image_hw=256)
        rec["write_s"] = time.perf_counter() - t0
        print(f"[{card}] wrote {GEO_SCENES} geometric scenes (20000 SDF rows a branch, "
              f"256x256) in {rec['write_s']:.2f} s", flush=True)

        # the flagship at full width, changed only as the TPU's proof ran:
        # one batch an epoch, the cross-mesh gate at 1001, no augmentation
        with open(os.path.join(REPO, "experiments", "obman_30k.json")) as f:
            raw = json.load(f)
        raw.update(DataSource=data_root, TrainSplit="", ScenesPerBatch=GEO_SCENES,
                   AdditionalLossStart=GEO_GATE, DisableAug=True, NumEpochs=GEO_STEPS)
        specs = flagship_specs(raw=raw)
        state, step = train_cli.make_trainer(specs, dev, seed=SEED, init_guard=True)
        dataset = make_train_dataset(specs, paths["train"], keys, raw_image=True)

        def experiment(name: str, spec=None) -> str:
            """An experiment directory holding specs.json (``spec``, by
            default the proof's) and, from the current state,
            ModelParameters/latest.pth."""
            exp = os.path.join(tmp, name)
            os.makedirs(exp)
            with open(os.path.join(exp, "specs.json"), "w") as f:
                json.dump(specs_to_dict(spec or specs), f, indent=2)
            ckpt.save_checkpoint(exp, state, state.epoch, "latest")
            return exp

        state.epoch = 0
        untrained = experiment("untrained")

        def batch_at(i: int):
            """The step's supervision: drawn anew every GEO_REDRAW steps
            (tests/test_overfit.py's seeds)."""
            items = [dataset.__getitem__(j, seed=(100 + j) if i == 0 else 1000 + 31 * i + j)
                     for j in range(len(keys))]
            return batch_to_device(to_train_batch(specs, collate(items)), dev)

        def train(state_x, step_x, bf16: bool):
            """GEO_STEPS steps of ``step_x`` on ``state_x``: K2's launches in
            the step's dtype (two a step each way, none of the other's),
            finite losses, hand_sdf and obj_sdf below their bounds' share of
            their first values, the joint loss falling.  Returns (the train
            record, the last batch)."""
            label = "bf16" if bf16 else "float32"
            gen = torch.Generator().manual_seed(SEED)
            logged = []
            restore_counts(k2, (0, 0, 0, 0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(GEO_STEPS):
                if i % GEO_REDRAW == 0:
                    batch = batch_at(i)
                state_x.epoch = i + 1  # one batch is one epoch
                losses = step_x(state_x, batch, draw_seed(gen))
                if i == 0 or (i + 1) % GEO_LOG_EVERY == 0:
                    logged.append((i + 1, losses))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts(k2)  # f32 fwd, bf16 fwd, f32 bwd, bf16 bwd
            mine, other = (counts[1::2], counts[0::2]) if bf16 else (counts[0::2], counts[1::2])
            launches = {"fwd": mine[0], "bwd": mine[1]}
            logged = [(n, {k: float(v) for k, v in ls.items()}) for n, ls in logged]
            first, last = logged[0][1], logged[-1][1]
            print(f"[{card}] {GEO_STEPS} steps in {label} in {wall:.2f} s: "
                  f"{wall / GEO_STEPS * 1e3:.2f} ms/step on the host clock (supervision re-drawn "
                  f"every {GEO_REDRAW} steps included); K2 launches {launches}, the other "
                  f"dtype's {other}", flush=True)
            for n, ls in logged:
                print(f"  step {n}: " + " ".join(f"{k}={v:.6f}" for k, v in sorted(ls.items())),
                      flush=True)
            want = k2.per_step * GEO_STEPS
            if launches != {"fwd": want, "bwd": want} or any(other):
                fail(f"geometric training in {label}: K2 launches {launches} (the other "
                     f"dtype's {other}) != {k2.per_step} a step")
            if not all(np.isfinite(v) for _, ls in logged for v in ls.values()):
                fail(f"geometric training in {label}: a non-finite loss")
            if not (last["hand_sdf"] < GEO_HAND_SDF_DROP * first["hand_sdf"]
                    and last["obj_sdf"] < GEO_OBJ_SDF_DROP * first["obj_sdf"]
                    and last["joint"] < first["joint"]):
                fail(f"geometric training in {label} did not learn: first {first}, last {last}")
            return {"steps": GEO_STEPS, "step_ms": wall / GEO_STEPS * 1e3,
                    "k2_launches": launches, "losses": logged}, batch

        phase(f"geometric training: {GEO_STEPS} steps of {GEO_SCENES} x "
              f"{specs.samples_per_scene} points through make_trainer's step (K2), the "
              f"cross-mesh gate at step {GEO_GATE}")
        rec["train"], batch = train(state, step, False)
        launches = rec["train"]["k2_launches"]
        gen = torch.Generator().manual_seed(SEED)
        trained = experiment("trained")

        # K2 on this path's own shape and weights: the last batch's latents
        # and point embeddings through the trained model
        phase(f"K2 vs plain on the proof's last batch ({GEO_SCENES} x {specs.samples_per_scene} "
              "points, trained weights, both trunks)")
        with torch.no_grad():
            latent, emb, _, _ = state.model.decoder_inputs_factored(
                batch["image"], batch["xyz"], {k: batch[k] for k in COND_KEYS}, train=False)
        rec["k2_check"] = k2_check(state.model, specs, dev, gen, GEO_SCENES, inputs=(latent, emb))
        k2_verdict(rec["k2_check"], "on the proof's last batch")

        def reconstruct(label, exp, extra, images, cube, source=("--samples", paths["samples"])):
            """cli.reconstruct.main on the samples npz (or ``source``'s
            images), K1's launches (its bf16 kernel's with --bf16, and no
            float32 one) held to two passes an image in runs of 2^20
            points."""
            grid_decode.launches = grid_decode.bf16_launches = 0
            t0 = time.perf_counter()
            per_image = reconstruct_cli.main(
                ["-e", exp, *source, "--end_point", str(images),
                 "--cube_dim", str(cube), "--device", dev.type, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = images * 2 * -(-cube ** 3 // (1 << 20))
            launches, other = grid_decode.launches, grid_decode.bf16_launches
            if "--bf16" in extra:
                launches, other = other, launches
            print(f"[{card}] {label}: {images} images at {cube}^3 in {wall:.2f} s, K1 launches "
                  f"{launches} (expected {want})", flush=True)
            if launches != want or other != 0 or len(per_image) != images:
                fail(f"{label}: K1 launches {launches} != {want} (or {other} of the other dtype)")
            for t in per_image:
                print(f"  {t['key']}: " + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in t.items()
                                                    if k != "key") + " ms", flush=True)
            return {"wall_s": wall, "launches": launches, "images": per_image}

        def evaluate(label, exp, modes):
            """cli.evaluate.main in each mode: every scene scored, no failure."""
            out = {}
            for mode in modes:
                summary = evaluate_cli.main(["-e", exp, "--data_root", paths["test"],
                                             "--workers", "8", *([f"--{mode}"] if mode != "hand"
                                                                 else [])])
                out[mode] = summary
                print(f"[{card}] {label}, {mode}: " + ", ".join(
                    f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in sorted(summary.items())), flush=True)
                if summary["failure_count"] != 0 or not all(
                        np.isfinite(v) for v in summary.values()):
                    fail(f"{label}, {mode}: {summary}")
            return out

        phase("geometric reconstruction and evaluation: cli.reconstruct, then cli.evaluate")
        runs = {}
        runs["untrained"] = reconstruct("untrained (its MANO joints)", untrained, [],
                                        GEO_SCENES, GEO_UNTRAINED_CUBE)
        runs["untrained"]["eval"] = evaluate("untrained", untrained, ["mano"])
        runs["128"] = reconstruct("trained", trained, [], GEO_SCENES, CUBE_DIM)
        runs["128"]["eval"] = evaluate("trained", trained, ["hand", "obj", "mano"])
        # the same trained weights into two more workspaces
        exp = experiment("eval_mode")
        runs["eval_mode"] = reconstruct("trained --eval_mode", exp, ["--eval_mode"],
                                        GEO_EVAL_IMAGES, CUBE_DIM)
        runs["eval_mode"]["eval"] = evaluate("trained --eval_mode", exp, ["hand", "obj"])
        exp = experiment("big")
        runs["256"] = reconstruct(f"trained at {GEO_BIG_CUBE}^3", exp, [], GEO_EVAL_IMAGES,
                                  GEO_BIG_CUBE)
        runs["256"]["eval"] = evaluate(f"trained at {GEO_BIG_CUBE}^3", exp, ["hand", "obj"])
        rec["runs"] = runs
        hand = runs["128"]["eval"]["hand"]["chamfer_mean"]
        obj = runs["128"]["eval"]["obj"]["chamfer_mean"]
        joint = runs["128"]["eval"]["mano"]["joint_err_mean"]
        joint0 = runs["untrained"]["eval"]["mano"]["joint_err_mean"]
        print(f"[{card}] proof of learning at {CUBE_DIM}^3 over {GEO_SCENES} scenes: hand chamfer "
              f"{hand:.4f} cm^2 (bound {GEO_HAND_CHAMFER_MAX}), object {obj:.4f} (bound "
              f"{GEO_OBJ_CHAMFER_MAX}), MANO joint error {joint:.3f} mm (untrained "
              f"{joint0:.3f})", flush=True)
        if not (hand <= GEO_HAND_CHAMFER_MAX and obj <= GEO_OBJ_CHAMFER_MAX and joint < joint0):
            fail("the trained model's reconstructions miss the proof's bounds")

        # the same scenes as a test split of JPEG files (cli.reconstruct -s,
        # ImagesDataset), scored as the --samples run: the writer stores
        # each image as its JPEG decodes, so both runs see the same pixels
        phase(f"geometric reconstruction from the test split's JPEGs: cli.reconstruct -s at "
              f"{CUBE_DIM}^3, then cli.evaluate")
        exp = experiment("split")
        runs["split"] = reconstruct("trained -s (JPEG files)", exp, [], GEO_SCENES, CUBE_DIM,
                                    source=("-s", paths["split"], "--data_root", paths["test"]))
        runs["split"]["eval"] = evaluate("trained -s", exp, ["hand", "obj"])
        # a scene without a mesh has no chamfer: no mean at all fails the bound
        split_hand = runs["split"]["eval"]["hand"].get("chamfer_mean", float("inf"))
        split_obj = runs["split"]["eval"]["obj"].get("chamfer_mean", float("inf"))
        items = ImagesDataset.from_split(paths["split"], specs, "obman", data_root=paths["test"])
        t0 = time.perf_counter()
        patches = [items[i]["image"] for i in range(len(items))]
        read_ms = (time.perf_counter() - t0) / len(items) * 1e3
        npz_images = np.load(paths["samples"])["image"]
        pixel_err = max(int(np.abs(p.astype(int) - r.astype(int)).max())
                        for p, r in zip(patches, npz_images))
        rec["split"] = {"hand_chamfer": split_hand, "obj_chamfer": split_obj,
                        "item_read_ms": read_ms, "pixel_max_level_err": pixel_err}
        print(f"[{card}] test split from JPEG files at {CUBE_DIM}^3 over {GEO_SCENES} scenes: "
              f"hand chamfer {split_hand:.4f} cm^2, object {split_obj:.4f} (the --samples "
              f"run's: {hand:.4f}, {obj:.4f}; bounds {GEO_HAND_CHAMFER_MAX}, "
              f"{GEO_OBJ_CHAMFER_MAX}); the split's patches against the samples npz's images "
              f"(the JPEGs decoded by the writer): largest difference {pixel_err} levels; host "
              f"time to read an item (JPEG decode and centre crop) {read_ms:.2f} ms", flush=True)
        if pixel_err != 0:
            fail("the test split's patches are not the images the samples npz holds")
        if not (split_hand <= GEO_HAND_CHAMFER_MAX and split_obj <= GEO_OBJ_CHAMFER_MAX):
            fail("the reconstructions from the test split's JPEGs miss the proof's bounds")

        # bf16 serving (phase 19's, on the proof's trained weights): the
        # same scenes with --bf16 (K1 in bf16) and ComputeDtype bfloat16
        # (the encoder and the plain decoder in bf16), scored as the float32
        # run, to the same bounds
        phase(f"geometric bf16 serving: cli.reconstruct --bf16 with ComputeDtype bfloat16 at "
              f"{CUBE_DIM}^3, then cli.evaluate")
        exp = experiment("bf16", dataclasses.replace(specs, compute_dtype="bfloat16"))
        bf = reconstruct("trained --bf16, ComputeDtype bfloat16", exp, ["--bf16"], GEO_SCENES,
                         CUBE_DIM)
        bf["eval"] = evaluate("trained --bf16", exp, ["hand", "obj"])
        bf_hand = bf["eval"]["hand"].get("chamfer_mean", float("inf"))
        bf_obj = bf["eval"]["obj"].get("chamfer_mean", float("inf"))
        bf.update(hand_chamfer=bf_hand, obj_chamfer=bf_obj)
        rec["bf16"] = bf
        print(f"[{card}] bf16 serving of the trained flagship at {CUBE_DIM}^3 over {GEO_SCENES} "
              f"scenes: hand chamfer {bf_hand:.4f} cm^2, object {bf_obj:.4f} (the float32 run's: "
              f"{hand:.4f}, {obj:.4f}; bounds {GEO_HAND_CHAMFER_MAX}, {GEO_OBJ_CHAMFER_MAX}); "
              "grid ms " + ", ".join(f"{t['grid_ms']:.1f}" for t in bf["images"]) + " (float32: "
              + ", ".join(f"{t['grid_ms']:.1f}" for t in runs["128"]["images"]) + ")", flush=True)
        if not (bf_hand <= GEO_HAND_CHAMFER_MAX and bf_obj <= GEO_OBJ_CHAMFER_MAX):
            fail("the bf16 reconstructions of the trained flagship miss the proof's bounds")

        # K1 on the trained weights' 256^3 plan (image 0's scene): its first
        # and last runs of 2^20 points (the highest indices) against the
        # plain version, then its time per pass
        phase(f"K1 vs plain on the trained weights' {GEO_BIG_CUBE}^3 plan, then K1 per pass")
        sample = {k: v[0] for k, v in np.load(paths["samples"]).items()}
        model = state.model.eval()
        with torch.no_grad():
            ctx = scene_ctx(model, specs, sample, dev)
            plan = make_grid_decode_fn(specs, GEO_BIG_CUBE)(ctx).plan
        n, chunk = GEO_BIG_CUBE, 1 << 20
        origin, voxel = torch.full((3,), -1.0, device=dev), torch.tensor(2.0 / (n - 1), device=dev)
        saved = grid_decode.launches
        k1_err = 0.0
        for start in (0, n ** 3 - chunk):
            out = grid_decode(plan, start, chunk, origin, voxel)
            torch.cuda.synchronize()
            ref = grid_decode_reference(plan, start, chunk, origin, voxel)
            k1_err = max(k1_err, float((out - ref).abs().max()))
        grid_decode.launches = saved  # comparison launches are not the main path's
        rec["k1_256_max_abs_err"] = k1_err
        print(f"K1 on the trained {n}^3 plan, points 0..{chunk} and {n ** 3 - chunk}..{n ** 3}: "
              f"max abs err vs plain {k1_err:.3e} (tolerance {K1_TOL:g})", flush=True)
        if not k1_err <= K1_TOL:
            fail(f"K1 disagrees with its plain version on the trained {n}^3 plan: {k1_err}")
        with torch.no_grad():
            plan_b = make_grid_decode_fn(specs, GEO_BIG_CUBE, torch.bfloat16)(ctx).plan
        saved = grid_decode.bf16_launches
        out = grid_decode(plan_b, 0, chunk, origin, voxel)
        torch.cuda.synchronize()
        c = bf16_compare(out, grid_decode_reference(plan_b, 0, chunk, origin, voxel))
        grid_decode.bf16_launches = saved
        bf16_verdict(f"K1 bf16 on the trained {n}^3 plan, points 0..{chunk}", c)
        rec["k1_bf16_256"] = c

        def one_pass():
            for start in range(0, n ** 3, chunk):
                grid_decode(plan, start, min(chunk, n ** 3 - start), origin, voxel)

        saved = grid_decode.launches
        k1_ms = cuda_ms(one_pass, 2)
        grid_decode.launches = saved
        flops = k1_flops_per_point(specs) * n ** 3
        bounds = grid_bounds(flops, 2 * 4 * n ** 3 + 4 * plan.flat.numel())
        rec["k1_256_ms"] = k1_ms
        print(f"[{card}] K1 per {n}^3 pass, trained weights: {k1_ms:.2f} ms "
              f"({flops / k1_ms / 1e9:.1f} TFLOP/s), {bounds_text(bounds)}", flush=True)
        # phase 20: the proof trained again in bf16 (ComputeDtype bfloat16: the
        # encoder on bf16 operands with the one-pass BatchNorm, K2 in bf16),
        # from the same init guard's draw, on the same supervision, then
        # served with --bf16 and scored to the same bounds; the TPU's proof
        # was a bf16 run (BASELINE.md)
        phase(f"geometric training in bf16 (phase 20): {GEO_STEPS} steps of {GEO_SCENES} x "
              f"{specs.samples_per_scene} points, ComputeDtype bfloat16 (K2 in bf16), then "
              f"cli.reconstruct --bf16 at {CUBE_DIM}^3 and cli.evaluate")
        specs_b = dataclasses.replace(specs, compute_dtype="bfloat16")
        state, step = train_cli.make_trainer(specs_b, dev, seed=SEED, init_guard=True)
        tb, _ = train(state, step, True)
        exp = experiment("trained_bf16", specs_b)
        pb = reconstruct("bf16-trained --bf16", exp, ["--bf16"], GEO_SCENES, CUBE_DIM)
        pb["eval"] = evaluate("bf16-trained", exp, ["hand", "obj", "mano"])
        pb_hand = pb["eval"]["hand"].get("chamfer_mean", float("inf"))
        pb_obj = pb["eval"]["obj"].get("chamfer_mean", float("inf"))
        pb_joint = pb["eval"]["mano"]["joint_err_mean"]
        pb.update(train=tb, hand_chamfer=pb_hand, obj_chamfer=pb_obj, joint_err=pb_joint)
        rec["bf16_trained"] = pb
        print(f"[{card}] proof of learning trained in bf16, served with --bf16 at {CUBE_DIM}^3 "
              f"over {GEO_SCENES} scenes: hand chamfer {pb_hand:.4f} cm^2 (bound "
              f"{GEO_HAND_CHAMFER_MAX}), object {pb_obj:.4f} (bound {GEO_OBJ_CHAMFER_MAX}), MANO "
              f"joint error {pb_joint:.3f} mm (untrained {joint0:.3f}); the float32-trained "
              f"run's {hand:.4f}, {obj:.4f}, {joint:.3f}; {tb['step_ms']:.2f} ms a step (float32 "
              f"{rec['train']['step_ms']:.2f})", flush=True)
        if not (pb_hand <= GEO_HAND_CHAMFER_MAX and pb_obj <= GEO_OBJ_CHAMFER_MAX
                and pb_joint < joint0):
            fail("the bf16-trained model's reconstructions miss the proof's bounds")
    rec["k1_launches"] = sum(r["launches"] for r in runs.values())
    rec["k2_launches"] = launches
    return rec


def host_read_timing(specs, lmdb_specs, root: str, keys) -> dict:
    """Host time, both backends on the same files at ``root`` (the page
    cache warm for both): each part of an item alone over every key, the
    whole item, then the loader over LOADER_REPEAT passes of the keys an
    epoch, LOADER_EPOCHS epochs.  Each thread builds a whole batch, so the
    batches arrive in waves, one a thread: the loader's rate is an epoch's
    time over its batches, and the wait for the first batch is kept
    beside it."""
    import numpy as np

    from alignsdf_torch.data import make_train_dataset

    timing = {}
    for name, sp in (("files", specs), ("lmdb", lmdb_specs)):
        ds = make_train_dataset(sp, root, keys, raw_image=True)
        be, n_sub = ds.backend, ds.num_samples_per_branch()
        parts = {"image": be.image, "meta": be.meta_params, "norm": be.normal_params,
                 "sdf": lambda k: [be.sample_sdf(k, hand, n_sub, sp.clamping_distance, True,
                                                 np.random.default_rng(0))
                                   for hand in (True, False)]}
        ms = {part: [] for part in (*parts, "item")}
        for i, key in enumerate(keys):
            for part, read in parts.items():
                t0 = time.perf_counter()
                read(key)
                ms[part].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            ds.__getitem__(i, seed=i)
            ms["item"].append((time.perf_counter() - t0) * 1e3)
        timing[name] = {**{f"{part}_ms": spread(v) for part, v in ms.items()},
                        **loader_epochs(make_train_dataset(sp, root, list(keys) * LOADER_REPEAT,
                                                           raw_image=True), sp, "thread")}
    return timing


def loader_epochs(dataset, specs, mode: str) -> dict:
    """The loader (DataLoaderThreads workers of ``mode``) over LOADER_EPOCHS
    epochs of the dataset: each epoch's time over its batches, its wait
    for the first batch, and its time from the first batch to the last over
    the batches after the first, in ms."""
    from alignsdf_torch.data.dataset import to_train_batch
    from alignsdf_torch.data.loader import DataLoader

    loader = DataLoader(dataset, batch_size=specs.scenes_per_batch,
                        num_workers=specs.data_loader_threads, seed=0,
                        to_batch=lambda stacked: to_train_batch(specs, stacked), worker_mode=mode)
    first, per_batch, rest = [], [], []
    for epoch in range(1, LOADER_EPOCHS + 1):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        ends = [time.perf_counter() for _ in loader]
        first.append((ends[0] - t0) * 1e3)
        per_batch.append((ends[-1] - t0) / len(ends) * 1e3)
        rest.append((ends[-1] - ends[0]) / (len(ends) - 1) * 1e3)
    return {"batch_first_ms": first, "batch_ms": per_batch, "batch_rest_ms": rest}


def files_phase(dev, card: str):
    """Phase 17, the reference's per-file layout (see the module
    docstring): cli.train from JPEG / npz / pkl files with the stem pool
    through K7, its post-training test through K1, then the same files
    packed by tools/create_lmdb_torch.py and read both ways."""
    import numpy as np
    import torch

    from alignsdf_torch.cli import train as train_cli
    from alignsdf_torch.data import make_train_dataset
    from alignsdf_torch.data.synthetic import write_synthetic_dataset
    from alignsdf_torch.kernels import maxpool as k7
    from alignsdf_torch.kernels.grid_decoder import grid_decode
    from alignsdf_torch.models import resnet

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import create_lmdb_torch

    rec = {"card": card}
    keys = [f"{i:08d}" for i in range(FILES_SCENES)]
    flags = ["--mano", "--obj_pose", "--encode", "both", "--point_size", "9", "--device", dev.type]
    k2 = k2_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        phase(f"per-file layout: {FILES_SCENES} scenes and a {FILES_TEST_IMAGES}-image test "
              "split written as JPEG, npz and pkl files")
        t0 = time.perf_counter()
        train = write_synthetic_dataset(tmp, keys, image_hw=256)
        test = write_synthetic_dataset(tmp, keys[:FILES_TEST_IMAGES], image_hw=256, seed=1,
                                       split="test")
        rec["write_s"] = time.perf_counter() - t0
        train_split, test_split = os.path.join(tmp, "train.json"), os.path.join(tmp, "test.json")
        with open(train_split, "w") as f:
            json.dump({"train": keys}, f)
        with open(test_split, "w") as f:
            json.dump({"filenames": [f"{k}.jpg" for k in keys[:FILES_TEST_IMAGES]]}, f)
        print(f"[{card}] wrote {FILES_SCENES} + {FILES_TEST_IMAGES} scenes (256x256 JPEGs, "
              f"4000 SDF rows a branch) in {rec['write_s']:.2f} s", flush=True)

        # the flagship JSON with LMDB false and the TrainSplit json, one epoch
        # of two batches, Resume naming a healthy init (the init guard's
        # draw, made before K7 is switched on) so that K7's launches are the
        # steps' alone
        with open(os.path.join(REPO, "experiments", "obman_30k.json")) as f:
            raw = json.load(f)
        state0, _ = train_cli.make_trainer(flagship_specs(), dev, seed=SEED, init_guard=True)
        resume = os.path.join(tmp, "init.pth")
        torch.save({"epoch": 0, "model_state_dict": state0.model.state_dict()}, resume)
        del state0
        raw.update(DataSource=tmp, TrainSplit=train_split, LMDB=False, NumEpochs=1,
                   LogFrequency=1, LogFrequencyStep=1, Resume=resume,
                   ScenesPerBatch=TRAIN_SCENES)
        specs = flagship_specs(raw=raw)
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(raw, f)
        out = os.path.join(tmp, "outputs")
        steps = FILES_SCENES // TRAIN_SCENES

        phase(f"per-file training: cli.train --data_root for one epoch of {steps} batches "
              f"with the stem pool through K7, then its post-training test of "
              f"{FILES_TEST_IMAGES} images at {CUBE_DIM}^3")
        k7.maxpool_forward.launches = k7.maxpool_backward.launches = 0
        k2.fwd.launches = k2.bwd.launches = 0
        grid_decode.launches = 0
        resnet.KERNEL_POOL = True
        try:
            t0 = time.perf_counter()
            train_cli.main(["-e", spec_path, *flags, "--data_root", train, "--output_root", out,
                            "--test_split", test_split, "--test_data_root", test])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            resnet.KERNEL_POOL = False
        launches = {"k7": {"fwd": k7.maxpool_forward.launches,
                           "bwd": k7.maxpool_backward.launches},
                    "k2": {"fwd": k2.fwd.launches, "bwd": k2.bwd.launches},
                    "k1": grid_decode.launches}
        exp = os.path.join(out, specs.experiment_name())
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            logged = [ln for ln in map(json.loads, f) if "step" in ln]
        pred = sorted(os.listdir(os.path.join(exp, "Eval_obman", "pred_mano")))
        meshes = sorted(os.listdir(os.path.join(exp, "Eval_obman", "meshes")))
        want_k1 = FILES_TEST_IMAGES * 2 * -(-CUBE_DIM ** 3 // (1 << 20))
        # K7's forward runs in the steps and in the test's encodes
        want_k7 = {"fwd": steps + FILES_TEST_IMAGES, "bwd": steps}
        print(f"[{card}] cli.train over the per-file layout: {wall:.2f} s for {len(logged)} "
              f"steps and the test; launches {launches} (expected K7 {want_k7}, K2 "
              f"{k2.per_step * steps}, K1 {want_k1}); total loss "
              + ", ".join(f"{s['total']:.5f}" for s in logged)
              + f"; test outputs: {len(pred)} MANO files, meshes {meshes}", flush=True)
        rec["train"] = {"wall_s": wall, "launches": launches,
                        "totals": [s["total"] for s in logged], "meshes": meshes}
        if len(logged) != steps:
            fail(f"per-file training: {len(logged)} steps logged, not {steps}")
        if not all(np.isfinite(v) for s in logged for v in s.values()):
            fail("per-file training: a non-finite loss")
        if launches["k7"] != want_k7:
            fail(f"per-file training: K7 launches {launches['k7']} != {want_k7}")
        if launches["k2"] != {"fwd": k2.per_step * steps, "bwd": k2.per_step * steps}:
            fail(f"per-file training: K2 launches {launches['k2']} != {k2.per_step} a step")
        if launches["k1"] != want_k1:
            fail(f"post-training test: K1 launches {launches['k1']} != {want_k1}")
        want_pred = sorted(f"{k}.{ext}" for k in keys[:FILES_TEST_IMAGES]
                           for ext in ("json", "ply"))
        if pred != want_pred:
            fail(f"post-training test: MANO outputs {pred} != {want_pred}")

        phase("per-file layout packed by tools/create_lmdb_torch.py: one item both ways, the "
              "loader from JPEGs and from the LMDBs")
        t0 = time.perf_counter()
        create_lmdb_torch.create_lmdbs(train, "obman", "train", keys)
        rec["pack_s"] = time.perf_counter() - t0
        from_files = make_train_dataset(specs, train, keys, raw_image=True)
        lmdb_specs = dataclasses.replace(specs, lmdb=True)
        from_lmdb = make_train_dataset(lmdb_specs, train, keys, raw_image=True)
        a, b = from_files.__getitem__(0, seed=3), from_lmdb.__getitem__(0, seed=3)
        item_err = max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
                             .max()) for k in a if k != "key")
        rec["item_max_abs_err"] = item_err
        print(f"[{card}] packed {FILES_SCENES} scenes in {rec['pack_s']:.2f} s; item 0 at seed 3 "
              f"from the files ({type(from_files.backend).__name__}) and from the LMDBs "
              f"({type(from_lmdb.backend).__name__}): max abs err {item_err:.3e} (tolerance "
              f"{FILES_ITEM_TOL:g})", flush=True)
        if set(a) != set(b) or a["key"] != b["key"] or not item_err <= FILES_ITEM_TOL:
            fail(f"the LMDB item disagrees with the per-file one: {item_err}")

        timing = host_read_timing(specs, lmdb_specs, train, keys)
        rec["timing"] = timing
        for name, what in (("files", "JPEG / pkl / npz files"), ("lmdb", "LMDBs")):
            t = timing[name]
            print(f"[{card}] host, from the {what}, ms an item over {FILES_SCENES} synthetic "
                  "scenes (256x256 uniform-noise JPEGs), median [p10, p90]: "
                  + ", ".join(f"{part} {fmt_spread(t[part + '_ms'])}"
                              for part in ("image", "meta", "norm", "sdf", "item"))
                  + f"; {TRAIN_SCENES} items one after another "
                  f"{t['item_ms']['median'] * TRAIN_SCENES:.1f} ms; the loader "
                  f"({specs.data_loader_threads} threads) a batch of {TRAIN_SCENES}, an epoch's "
                  f"time over its {FILES_SCENES * LOADER_REPEAT // TRAIN_SCENES} batches: "
                  + ", ".join(f"{v:.1f}" for v in t["batch_ms"]) + " ms in its "
                  f"{LOADER_EPOCHS} epochs, the first batch after "
                  + ", ".join(f"{v:.1f}" for v in t["batch_first_ms"]), flush=True)
    rec["k1_launches"] = launches["k1"]
    rec["k2_launches"] = launches["k2"]
    rec["k7_launches"] = launches["k7"]
    return rec


def _send_batches(conn, batch, reps: int) -> None:
    """A forked child's part of the pipe timing: send ``batch`` reps times."""
    for _ in range(reps):
        conn.send(batch)
    conn.close()


def pipe_timing(batch) -> dict:
    """What a batch costs to cross from a forked worker to the parent, as
    the process loader moves it: its pickled size, the parent's wait for
    each of IPC_REPS sends (the child pickles and writes, the parent reads
    and unpickles), and pickling and unpickling alone in the parent."""
    import multiprocessing as mp
    import pickle

    t0 = time.perf_counter()
    blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
    dumps_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pickle.loads(blob)
    loads_ms = (time.perf_counter() - t0) * 1e3
    ctx = mp.get_context("fork")
    recv_end, send_end = ctx.Pipe(duplex=False)
    child = ctx.Process(target=_send_batches, args=(send_end, batch, IPC_REPS), daemon=True)
    child.start()
    send_end.close()
    recv_ms = []
    try:
        for _ in range(IPC_REPS):
            t0 = time.perf_counter()
            recv_end.recv()
            recv_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.terminate()
        recv_end.close()
    return {"mb": len(blob) / 1e6, "recv_ms": recv_ms, "dumps_ms": dumps_ms,
            "loads_ms": loads_ms}


class _WaitClock:
    """A train loader whose every batch's wait (the parent's ``next`` on
    the loader) is clocked into ``waits``."""

    def __init__(self, loader, waits: list):
        self.loader, self.waits = loader, waits

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        batches = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


class StepClock:
    """The train CLI's step, wrapped through ``cli.train.make_trainer``: each
    step clocked on the host from the end of the step before (synchronized),
    so the loader's wait and the batch's copy to the card are in it, and
    ``profiled`` steps from step index ``profile_at`` under torch.profiler;
    through ``cli.train.make_loader``, the loader's wait for each batch
    alone."""

    def __init__(self, profile_at: int, profiled: int):
        self.profile_at, self.profiled = profile_at, profiled
        self.step_s, self.wait_s, self.prof, self.prof_wall = [], [], None, None

    def wrap_loader(self, make_loader):
        def make(*args, **kwargs):
            return _WaitClock(make_loader(*args, **kwargs), self.wait_s)

        return make

    def wrap(self, make_trainer):
        import torch
        from torch.profiler import ProfilerActivity, profile

        def make(*args, **kwargs):
            state, step = make_trainer(*args, **kwargs)
            self.t_last = time.perf_counter()

            def timed(st, batch, seed, **kw):
                i = len(self.step_s)
                if i == self.profile_at:
                    self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    self.prof.__enter__()
                    self.t_prof = self.t_last
                out = step(st, batch, seed, **kw)
                torch.cuda.synchronize()
                t = time.perf_counter()
                self.step_s.append(t - self.t_last)
                self.t_last = t
                if i == self.profile_at + self.profiled - 1:
                    self.prof.__exit__(None, None, None)
                    self.prof_wall = t - self.t_prof
                    self.t_last = time.perf_counter()  # the profiler's teardown is no step's
                return out

            timed.decode = step.decode
            return state, timed

        return make


def packed_phase(dev, card: str):
    """Phase 18, feeding the card from disk (see the module docstring): a
    pack of the per-file layout read natively, the loader by route, and
    cli.train from the pack and from LMDBs under forked workers."""
    import numpy as np
    import torch

    from alignsdf_torch.cli import train as train_cli
    from alignsdf_torch.data import make_train_dataset
    from alignsdf_torch.data.synthetic import write_synthetic_dataset
    from alignsdf_torch.kernels import maxpool as k7
    from alignsdf_torch.kernels.grid_decoder import grid_decode
    from alignsdf_torch.models import resnet

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import create_lmdb_torch
    import pack_dataset_torch

    rec = {"card": card, "cpus": os.cpu_count(), "cpus_usable": len(os.sched_getaffinity(0))}
    keys = [f"{i:08d}" for i in range(PACK_SCENES)]
    flags = ["--mano", "--obj_pose", "--encode", "both", "--point_size", "9", "--device", dev.type]
    k2 = k2_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        phase(f"pack: {PACK_SCENES} scenes written as JPEG, npz and pkl files, packed by "
              "tools/pack_dataset_torch.py and by tools/create_lmdb_torch.py")
        t0 = time.perf_counter()
        train = write_synthetic_dataset(tmp, keys, image_hw=256)
        test = write_synthetic_dataset(tmp, keys[:PACK_TEST_IMAGES], image_hw=256, seed=1,
                                       split="test")
        rec["write_s"] = time.perf_counter() - t0
        pack = os.path.join(tmp, "train.pack")
        t0 = time.perf_counter()
        pack_dataset_torch.pack(train, pack, keys, "obman")
        rec["pack_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        create_lmdb_torch.create_lmdbs(train, "obman", "train", keys)
        rec["lmdb_s"] = time.perf_counter() - t0
        with open(os.path.join(REPO, "experiments", "obman_30k.json")) as f:
            raw = json.load(f)
        specs = flagship_specs(raw=dict(raw, LMDB=False, ScenesPerBatch=TRAIN_SCENES))
        t0 = time.perf_counter()
        ds = make_train_dataset(specs, None, raw_image=True, pack_path=pack)
        reader = ds.backend.reader
        rec["open_s"] = time.perf_counter() - t0  # the reader's g++ build at first use
        print(f"[{card}] host CPUs {rec['cpus']} ({rec['cpus_usable']} usable); wrote "
              f"{PACK_SCENES} + {PACK_TEST_IMAGES} scenes in {rec['write_s']:.2f} s, packed in "
              f"{rec['pack_s']:.2f} s ({os.path.getsize(pack) / 1e6:.1f} MB), the LMDBs in "
              f"{rec['lmdb_s']:.2f} s; the native reader built and the pack opened in "
              f"{rec['open_s']:.2f} s", flush=True)

        phase(f"pack: the native batch of {TRAIN_SCENES} scenes against the item path "
              "(augmentation off), and at 1 thread against all threads (augmentation on)")
        noaug = make_train_dataset(dataclasses.replace(specs, disable_aug=True), None,
                                   raw_image=True, pack_path=pack)
        idx = list(range(TRAIN_SCENES))
        seeds = [1000 + i for i in idx]
        batch = noaug.build_batch(idx, seeds)
        per, n = noaug.num_samples_per_branch(), specs.samples_per_scene
        k = specs.sdf_scale_factor
        err, mismatched = 0.0, 0
        for b in idx:
            item = noaug.__getitem__(b, seed=0)
            raw_img = noaug.backend.image(noaug.keys[b])
            mismatched += int((batch["image"][b] != raw_img).sum()
                              + (item["image"] != raw_img).sum())
            for field in ("hand_joints_3d", "cam_intr", "mano_root", "rest_obj_corners",
                          "obj_center", "obj_corners"):
                err = max(err, float(np.abs(batch[field][b] - item[field]).max()))
            scale_arr, offset = noaug.backend.normal_params(noaug.keys[b])
            rec_i = noaug.backend._key_to_idx[noaug.keys[b]]
            for hand, tag, row0 in ((True, 0x68616E64, 0), (False, 0x6F626A00, per)):
                raw_s, raw_l = reader.sample_sdf(rec_i, hand, per, specs.clamping_distance, True,
                                                 seeds[b] ^ tag)
                rows = slice(b * n + row0, b * n + row0 + per)
                want = ((raw_s[:, :3] / scale_arr[0] - offset) - item["mano_root"]) * k / 2
                err = max(err, float(np.abs(batch["xyz"][rows] - want).max()),
                          float(np.abs(batch["sdf_gt_hand"][rows, 0]
                                       - raw_s[:, 3] / scale_arr[0] * k / 2).max()),
                          float(np.abs(batch["sdf_gt_obj"][rows, 0]
                                       - raw_s[:, 4] / scale_arr[0] * k / 2).max()))
                mismatched += int((batch["labels"][rows] != raw_l.astype(np.int32)).sum())
        rec["item_max_abs_err"] = err
        ms = {}
        for threads in (1, 0):
            t0 = time.perf_counter()
            out = reader.build_batch(idx, seeds, specs, num_threads=threads)
            ms[threads or "all"] = (time.perf_counter() - t0) * 1e3
            if threads:
                one = out
        same = all(np.array_equal(one[f], out[f]) for f in one)
        rotated = int((~out["image"][:, :4, :4].reshape(TRAIN_SCENES, -1).any(axis=1)).sum())
        rec["build_batch_ms"] = ms
        print(f"[{card}] the native batch against the item path over {TRAIN_SCENES} scenes: "
              f"images and labels differing in {mismatched} entries, the other fields and the "
              f"sampled rows max abs err {err:.3e} (tolerance {PACK_ITEM_TOL:g}); with "
              f"augmentation ({rotated} of {TRAIN_SCENES} scenes rotated) one thread "
              f"{ms[1]:.1f} ms, all threads {ms['all']:.1f} ms, bit for bit "
              f"{'equal' if same else 'DIFFERENT'}", flush=True)
        if mismatched or not err <= PACK_ITEM_TOL:
            fail(f"the native batch disagrees with the item path: {mismatched} entries, {err}")
        if not same or not rotated:
            fail(f"the native batch: threads equal {same}, {rotated} scenes rotated")
        rec["ipc"] = pipe_timing(out)
        ipc = rec["ipc"]
        print(f"[{card}] a batch through a pipe from a forked child: {ipc['mb']:.1f} MB "
              f"pickled; the parent's wait a batch {fmt_spread(spread(ipc['recv_ms']))} ms over "
              f"{IPC_REPS} sends; pickling {ipc['dumps_ms']:.1f} ms and unpickling "
              f"{ipc['loads_ms']:.1f} ms in the parent", flush=True)

        phase(f"pack: the loader by route over {LOADER_EPOCHS} epochs of "
              f"{PACK_SCENES // TRAIN_SCENES} batches of {TRAIN_SCENES}")
        lmdb_specs = dataclasses.replace(specs, lmdb=True)
        routes = (("pack, threads", ds, specs, "thread"),
                  ("pack, processes", ds, specs, "process"),
                  ("LMDBs, threads", make_train_dataset(lmdb_specs, train, keys, raw_image=True),
                   lmdb_specs, "thread"),
                  ("LMDBs, processes", None, lmdb_specs, "process"),
                  ("files, processes", make_train_dataset(specs, train, keys, raw_image=True),
                   specs, "process"))
        rec["loader"] = {}
        for name, dataset, sp, mode in routes:
            if dataset is None:
                dataset = routes[2][1]
            t = rec["loader"][name] = loader_epochs(dataset, sp, mode)
            print(f"[{card}] loader from the {name} ({sp.data_loader_threads} workers): an "
                  "epoch's time over its batches "
                  + ", ".join(f"{v:.1f}" for v in t["batch_ms"]) + " ms, the first batch after "
                  + ", ".join(f"{v:.1f}" for v in t["batch_first_ms"]) + " ms, the rest "
                  + ", ".join(f"{v:.1f}" for v in t["batch_rest_ms"]) + " ms a batch", flush=True)

        # the flagship JSON with a TrainSplit naming each key twice, Resume
        # naming a healthy init (the init guard's draw, made before K7 is
        # switched on) so that K7's launches are the steps' alone
        state0, _ = train_cli.make_trainer(flagship_specs(), dev, seed=SEED, init_guard=True)
        resume = os.path.join(tmp, "init.pth")
        torch.save({"epoch": 0, "model_state_dict": state0.model.state_dict()}, resume)
        del state0
        split, test_split = os.path.join(tmp, "train.json"), os.path.join(tmp, "test.json")
        with open(split, "w") as f:
            json.dump({"train": keys * PACK_TRAIN_REPEAT}, f)
        with open(test_split, "w") as f:
            json.dump({"filenames": [f"{key}.jpg" for key in keys[:PACK_TEST_IMAGES]]}, f)
        raw.update(TrainSplit=split, LMDB=True, NumEpochs=1, LogFrequency=1, LogFrequencyStep=1,
                   Resume=resume, ScenesPerBatch=TRAIN_SCENES)
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(raw, f)
        steps = PACK_SCENES * PACK_TRAIN_REPEAT // TRAIN_SCENES
        want_k1 = PACK_TEST_IMAGES * 2 * -(-CUBE_DIM ** 3 // (1 << 20))
        want = {"k7": {"fwd": steps + PACK_TEST_IMAGES, "bwd": steps},
                "k2": {"fwd": k2.per_step * steps, "bwd": k2.per_step * steps}, "k1": want_k1}
        rec["train"] = {}
        real_make_trainer, real_make_loader = train_cli.make_trainer, train_cli.make_loader
        runs = (("pack", ["--packed", pack], "--packed"),
                ("LMDBs, threads", ["--data_root", train], "--data_root (the LMDBs), threads"),
                ("LMDBs, processes", ["--data_root", train, "--loader_mode", "process"],
                 "--data_root (the LMDBs) --loader_mode process"),
                # phase 20: the same pack in bf16 (K7 and K2 on their bf16 kernels)
                ("pack, bf16", ["--packed", pack, "--bf16"], "--packed --bf16"))
        for name, source, text in runs:
            bf16 = "--bf16" in source
            phase(f"training from the {name}{' (phase 20)' if bf16 else ''}: cli.train {text} "
                  f"for one epoch of {steps} batches with the stem pool through K7, then its "
                  f"post-training test of {PACK_TEST_IMAGES} images at {CUBE_DIM}^3")
            clock = StepClock(PACK_STEADY_SKIP + PACK_STEADY_STEPS, PACK_PROFILED)
            out = os.path.join(tmp, f"out_{len(rec['train'])}")
            k7.maxpool_forward.launches = k7.maxpool_backward.launches = 0
            k7.maxpool_forward.bf16_launches = k7.maxpool_backward.bf16_launches = 0
            restore_counts(k2, (0, 0, 0, 0))
            grid_decode.launches = grid_decode.bf16_launches = 0
            train_cli.make_trainer = clock.wrap(real_make_trainer)
            train_cli.make_loader = clock.wrap_loader(real_make_loader)
            resnet.KERNEL_POOL = True
            try:
                t0 = time.perf_counter()
                train_cli.main(["-e", spec_path, *flags, *source, "--output_root", out,
                                "--test_split", test_split, "--test_data_root", test,
                                "--test_cube_dim", str(CUBE_DIM)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                resnet.KERNEL_POOL = False
                train_cli.make_trainer, train_cli.make_loader = real_make_trainer, real_make_loader
            # the run's dtype's counters; the other dtype's (K1's bf16, K2's
            # and K7's float32 in a bf16 run) must stay 0
            k2c = launch_counts(k2)  # f32 fwd, bf16 fwd, f32 bwd, bf16 bwd
            k7c = (k7.maxpool_forward.launches, k7.maxpool_forward.bf16_launches,
                   k7.maxpool_backward.launches, k7.maxpool_backward.bf16_launches)
            pick = (lambda c: (c[1], c[3])) if bf16 else (lambda c: (c[0], c[2]))
            drop = (lambda c: (c[0], c[2])) if bf16 else (lambda c: (c[1], c[3]))
            launches = {"k7": dict(zip(("fwd", "bwd"), pick(k7c))),
                        "k2": dict(zip(("fwd", "bwd"), pick(k2c))),
                        "k1": grid_decode.launches}
            if any(drop(k7c)) or any(drop(k2c)) or grid_decode.bf16_launches:
                fail(f"training from the {name}: launches of the other dtype's kernels: K7 "
                     f"{drop(k7c)}, K2 {drop(k2c)}, K1 bf16 {grid_decode.bf16_launches}")
            exp = os.path.join(out, flagship_specs(raw=raw).experiment_name())
            with open(os.path.join(exp, "metrics.jsonl")) as f:
                logged = [ln for ln in map(json.loads, f) if "step" in ln]
            pred = sorted(os.listdir(os.path.join(exp, "Eval_obman", "pred_mano")))
            if len(logged) != steps or len(clock.step_s) != steps or len(clock.wait_s) != steps:
                fail(f"training from the {name}: {len(logged)} steps logged, "
                     f"{len(clock.step_s)} clocked, {len(clock.wait_s)} batches waited on, "
                     f"not {steps}")
            window = slice(PACK_STEADY_SKIP, PACK_STEADY_SKIP + PACK_STEADY_STEPS)
            tail = PACK_STEADY_SKIP + PACK_STEADY_STEPS + PACK_PROFILED
            steady = np.array(clock.step_s[window]) * 1e3
            waits = np.array(clock.wait_s[window]) * 1e3
            r = rec["train"][name] = {
                "wall_s": wall, "launches": launches, "totals": [s["total"] for s in logged],
                "step_ms": [v * 1e3 for v in clock.step_s],
                "wait_ms": [v * 1e3 for v in clock.wait_s],
                "epoch_ms_per_step": sum(clock.step_s) * 1e3 / steps,
                "after_first_ms_per_step": sum(clock.step_s[1:]) * 1e3 / (steps - 1),
                "tail_ms_per_step": sum(clock.step_s[tail:]) * 1e3 / (steps - tail),
                "steady_steps": [window.start + 1, window.stop],
                "step_ms_median": float(np.median(steady)), "step_ms_mean": float(steady.mean()),
                "step_ms_min_max": [float(steady.min()), float(steady.max())],
                "wait_ms_median": float(np.median(waits)), "wait_ms_mean": float(waits.mean())}
            summary = (profile_summary(clock.prof, clock.prof_wall)
                       if clock.prof_wall is not None else None)
            if summary is not None:
                busy, share, _ = summary
                r["profile"] = {"step_wall_ms": clock.prof_wall * 1e3 / PACK_PROFILED,
                                "device_busy_ms": busy / PACK_PROFILED, "idle_share": 1 - share}
            print(f"[{card}] cli.train from the {name}: {wall:.2f} s for {len(logged)} steps "
                  f"and the test; the epoch's time over its steps {r['epoch_ms_per_step']:.2f} ms "
                  f"(the first {clock.step_s[0] * 1e3:.1f} ms, the rest "
                  f"{r['after_first_ms_per_step']:.2f} a step, the last {steps - tail} "
                  f"{r['tail_ms_per_step']:.2f}); steps {window.start + 1}-"
                  f"{window.stop} median {r['step_ms_median']:.2f} ms, mean "
                  f"{r['step_ms_mean']:.2f} ({r['step_ms_min_max'][0]:.2f}-"
                  f"{r['step_ms_min_max'][1]:.2f}) on the host clock, of which the loader's wait "
                  f"median {r['wait_ms_median']:.2f} ms, mean {r['wait_ms_mean']:.2f}; "
                  + (f"steps {tail - PACK_PROFILED + 1}-{tail} profiled: "
                     f"{r['profile']['step_wall_ms']:.2f} ms "
                     f"a step, device busy {r['profile']['device_busy_ms']:.2f} ms, idle share "
                     f"{r['profile']['idle_share']:.3f}" if summary is not None else
                     "profile: not measured (no device events)")
                  + f"; launches {launches} (expected {want}); total loss "
                  + ", ".join(f"{s['total']:.5f}" for s in logged), flush=True)
            if not all(np.isfinite(v) for s in logged for v in s.values()):
                fail(f"training from the {name}: a non-finite loss")
            if launches != want:
                fail(f"training from the {name}: launches {launches} != {want}")
            want_pred = sorted(f"{key}.{ext}" for key in keys[:PACK_TEST_IMAGES]
                               for ext in ("json", "ply"))
            if pred != want_pred:
                fail(f"training from the {name}: test outputs {pred} != {want_pred}")
    bf = rec["train"]["pack, bf16"]
    f32 = rec["train"]["pack"]
    print(f"[{card}] cli.train --packed, steps {PACK_STEADY_SKIP + 1}-"
          f"{PACK_STEADY_SKIP + PACK_STEADY_STEPS} median: bf16 {bf['step_ms_median']:.2f} ms "
          f"({bf['step_ms_min_max'][0]:.2f}-{bf['step_ms_min_max'][1]:.2f}), float32 "
          f"{f32['step_ms_median']:.2f} ms ({f32['step_ms_min_max'][0]:.2f}-"
          f"{f32['step_ms_min_max'][1]:.2f}) in the same call", flush=True)
    rec["train_bf16"] = rec["train"].pop("pack, bf16")
    for kernel in ("k1", "k2", "k7"):
        rec[f"{kernel}_launches"] = {name: r["launches"][kernel]
                                     for name, r in rec["train"].items()}
    return rec


def bf16_compare(out, ref) -> dict:
    """A bf16 kernel's rows against its plain bf16 version: the SDF rows'
    largest error, the logits' over their largest magnitude where it exceeds
    1 (or None), and the share of entries beyond BF16_TIGHT (on that
    scale)."""
    c, beyond = {"logits_max_err": None}, 0
    for k, r, key in ((out[:2], ref[:2], "max_abs_err"), (out[2:], ref[2:], "logits_max_err")):
        if k.numel() == 0:
            continue
        e = (k - r).abs() / (max(1.0, float(r.abs().max())) if key == "logits_max_err" else 1.0)
        c[key] = float(e.max())
        beyond += int((e > BF16_TIGHT).sum())
    c["share_beyond"] = beyond / out.numel()
    return c


def bf16_verdict(label: str, c: dict) -> None:
    logits = c["logits_max_err"]
    print(f"{label}: bf16 kernel vs its plain bf16 version: max abs err {c['max_abs_err']:.3e} "
          f"(tolerance {BF16_LOOSE:g})" + ("" if logits is None else
                                           f", logits {logits:.3e} of their largest "
                                           f"(tolerance {BF16_LOGIT_LOOSE:g})")
          + f", share beyond {BF16_TIGHT:g} {c['share_beyond']:.5f} (at most "
          f"{1 - BF16_SHARE:g})", flush=True)
    if not (c["max_abs_err"] <= BF16_LOOSE and c["share_beyond"] <= 1 - BF16_SHARE
            and (logits is None or logits <= BF16_LOGIT_LOOSE)):
        fail(f"{label}: the bf16 kernel disagrees with its plain bf16 version: {c}")


def vs_float32(label: str, kb, kf, voxel) -> dict:
    """A bf16 field (rows 0-1) against the float32 kernel's on the same
    points: the largest difference (at most BF16_VS_F32_TOL, JAX's bf16
    bound) and the near-surface sign flips (cells with |sdf| < voxel in the
    float32 field whose sign the bf16 field flips; BASELINE.md row 50)."""
    diff = float((kb[:2] - kf[:2]).abs().max())
    near = kf[:2].abs() < float(voxel)
    flips = int((near & ((kb[:2] < 0) != (kf[:2] < 0))).sum())
    rec = {"max_abs_diff": diff, "near_surface": int(near.sum()), "flips": flips}
    print(f"{label}: bf16 field vs the float32 kernel's: max abs diff {diff:.3e} (tolerance "
          f"{BF16_VS_F32_TOL:g}); near-surface sign flips {flips} of {rec['near_surface']} "
          "cells", flush=True)
    if not diff <= BF16_VS_F32_TOL:
        fail(f"{label}: the bf16 field is {diff} from the float32 kernel's")
    return rec


def shift_final_biases(model, specs, sample, dev) -> None:
    """Seeded weights of twin trunks: shift their final biases so ~5% of a
    64^3 first pass is inside (the field crosses zero and meshes come out),
    on the fused plan's plain version (K1's, or K3's for a pixel-aligned
    spec)."""
    import torch

    from alignsdf_torch.kernels.grid_decoder import grid_decode_reference
    from alignsdf_torch.kernels.pixel_grid_decoder import pixel_grid_decode_reference
    from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
    from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

    make, plain = ((make_pixel_grid_decode_fn, pixel_grid_decode_reference) if specs.pixel_align
                   else (make_grid_decode_fn, grid_decode_reference))
    plan = make(specs, 64)(scene_ctx(model, specs, sample, dev)).plan
    last = len(specs.network_specs.dims)
    with torch.no_grad():
        first = plain(plan, 0, 64 ** 3, torch.full((3,), -1.0, device=dev),
                      torch.tensor(2.0 / 63, device=dev))
        for row, name in ((0, f"linh{last}"), (1, f"lino{last}")):
            q = torch.quantile(first[row], 0.05).clamp(-0.999, 0.999)
            getattr(model.decoder, name).bias -= torch.atanh(q)


def bf16_model(model, specs, dev):
    """The same weights in a model whose ComputeDtype is bfloat16."""
    import dataclasses

    from alignsdf_torch.models.alignsdf import build_model

    specs_b = dataclasses.replace(specs, compute_dtype="bfloat16")
    model_b = build_model(specs_b, device=dev)
    model_b.load_state_dict(model.state_dict())
    return model_b.eval(), specs_b


def bf16_main_path(label, model, specs, samples, dev, card, mano_faces, kernel, per_image,
                   decode_fn=None) -> dict:
    """run_pipelined over the samples with --bf16 (grid_dtype bfloat16) and
    ComputeDtype bfloat16: the kernel's bf16 launches (``per_image`` a run)
    and no float32 one, finite fields, meshes; the encode and grid ms of each
    image, then a warm and a profiled run (images/s, the idle share)."""
    import torch

    from alignsdf_torch.inference.reconstruct import Reconstructor, make_output_dirs, run_pipelined

    model_b, specs_b = bf16_model(model, specs, dev)
    recon = Reconstructor(model_b, specs_b, cube_dim=CUBE_DIM, mano_faces=mano_faces,
                          grid_dtype=torch.bfloat16, decode_fn=decode_fn)
    expected = len(samples) * per_image
    results = []
    with tempfile.TemporaryDirectory() as out:
        dirs = make_output_dirs(out)
        kernel.launches = kernel.bf16_launches = 0
        t0 = time.perf_counter()
        done = run_pipelined(recon, samples, dirs, on_done=lambda i, p: results.append((i, p)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, f32_launches = kernel.bf16_launches, kernel.launches
        written = sorted(os.listdir(dirs["meshes"]))
    print(f"{label} (--bf16, ComputeDtype bfloat16): images {done}, wall {wall * 1e3:.1f} ms, "
          f"bf16 kernel launches {launches} (expected {expected}), float32 kernel launches "
          f"{f32_launches}, meshes written {len(written)}", flush=True)
    if done != len(samples) or launches != expected or f32_launches != 0:
        fail(f"{label}: bf16 launches {launches} != {expected} or float32 launches "
             f"{f32_launches} != 0")
    if not written:
        fail(f"{label}: no mesh was written")
    rec = {"wall_ms": wall * 1e3, "launches": launches, "meshes": len(written), "images": []}
    for i, pending in results:
        host = pending["host"]
        for name in ("sdf_hand", "sdf_obj"):
            if (tuple(host[name].shape) != (CUBE_DIM,) * 3
                    or not bool(torch.isfinite(host[name]).all())):
                fail(f"{label} image {i}: {name} has the wrong shape or non-finite values")
        t = pending["timings"]
        print(f"{label} image {i} [{card}]: encode {t['encode_ms']:.2f} ms, grid "
              f"{t['grid_ms']:.2f} ms (2 passes), {host_text(t)}", flush=True)
        rec["images"].append(t)
    rec["warm"], profiled = warm_and_profiled(recon, samples, kernel, card, f"{label} bf16 ")
    kernel.bf16_launches = launches
    if profiled is not None:
        rec["profile"] = profiled
        rec["idle_share"] = 1 - profiled["busy_share"]
    return rec


def bf16_phase(dev, card: str, gen, mano_faces, model) -> Tuple[dict, list]:
    """Phase 19, bf16 serving: K1 (the flagship, ``model`` with phase 5's
    shifted biases), K3 (--pa_feat) and K6 (--point_size 63 --pallas) on
    bf16 plans at full width: each bf16 kernel against its plain bf16
    version over both 128^3 passes of image 0 (K1 and K3 also at 2 + C rows
    on the classifier specs, C = 6, the first pass) and against the float32
    kernel's field; each timed per pass beside its bf16 and split-TF32
    bounds and the float32 kernel; run_pipelined over 3 images with --bf16
    and ComputeDtype bfloat16; then BASELINE.json's configs 1 and 2 served
    in float32 and in bf16.  Returns (record, the kernels-line entries)."""
    import torch

    from alignsdf_torch.inference.grid import _refine_cube
    from alignsdf_torch.kernels.generic_decoder import generic_decode, generic_decode_reference
    from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference
    from alignsdf_torch.kernels.pixel_grid_decoder import (
        pixel_grid_decode, pixel_grid_decode_reference, pixel_projection)
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.models.decoder import separate_decoder_inputs
    from alignsdf_torch.ops.decoder_plan import make_generic_decode_fn, make_generic_plan
    from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
    from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

    bf16 = torch.bfloat16
    n, total = CUBE_DIM, CUBE_DIM ** 3
    origin0 = torch.full((3,), -1.0, device=dev)
    voxel0 = torch.tensor(2.0 / (n - 1), device=dev)
    samples = synthetic_samples(gen, N_IMAGES)
    rec, entries = {}, []

    pixel_specs = flagship_specs(pixel=True)
    pixel_model = build_model(pixel_specs, device=dev, seed=SEED)
    shift_final_biases(pixel_model, pixel_specs, samples[0], dev)
    g_specs, g_model = generic_model(dev, samples[0])
    specs = flagship_specs()

    def generic_pass(kernel, plan, ctx, origin, voxel):
        outs = []
        for rows in generic_rows(g_specs, ctx, n, origin, voxel, dev):
            h, o, _ = kernel(plan, *separate_decoder_inputs(
                g_specs.latent_size, g_specs.encode_style, rows.to(plan.dtype)))
            outs.append(torch.cat([h, o], dim=1).T)
        return torch.cat(outs, dim=1)

    # the three routes: (name, wrapper, plain version, specs, model, plan(ctx, dtype),
    # pass(fn, plan, ctx, origin, voxel), launches an image, FLOPs a pass (K3's: from the
    # pass's in-image points, below), the TPU kernel, the source)
    routes = [
        ("K1", grid_decode, grid_decode_reference, specs, model,
         lambda ctx, dt: make_grid_decode_fn(specs, n, dt)(ctx).plan,
         lambda fn, plan, ctx, o, v: fused_pass(fn, plan, o, v), 2 * -(-total // (1 << 20)),
         k1_flops_per_point(specs) * total, "alignsdf_tpu/ops/decoder_kernel.py:496",
         "alignsdf_torch/kernels/csrc/grid_decoder.cu"),
        ("K3", pixel_grid_decode, pixel_grid_decode_reference, pixel_specs, pixel_model,
         lambda ctx, dt: make_pixel_grid_decode_fn(pixel_specs, n, False, dt)(ctx).plan,
         lambda fn, plan, ctx, o, v: fused_pass(fn, plan, o, v), 2 * -(-total // (1 << 20)),
         None, "alignsdf_tpu/ops/decoder_kernel.py:884",
         "alignsdf_torch/kernels/csrc/pixel_grid_decoder.cu"),
        ("K6", generic_decode, generic_decode_reference, g_specs, g_model,
         lambda ctx, dt: make_generic_plan(g_model.decoder, g_specs, dt),
         generic_pass, 2 * -(-total // (1 << 18)),
         2 * generic_macs_per_point(g_specs) * total, "alignsdf_tpu/ops/decoder_kernel.py:139",
         "alignsdf_torch/kernels/csrc/generic_decoder.cu"),
    ]
    for name, kernel, plain, r_specs, r_model, plan_of, run_pass, per_image, flops, line, src \
            in routes:
        phase(f"bf16 serving, {name}: the bf16 kernel vs its plain bf16 version over both "
              f"{n}^3 passes of image 0, and vs the float32 kernel's field")
        ctx = scene_ctx(r_model, r_specs, samples[0], dev)
        plan_b, plan_f = plan_of(ctx, bf16), plan_of(ctx, torch.float32)
        saved = (kernel.launches, kernel.bf16_launches)
        origin, voxel = origin0, voxel0
        checks, flips = [], []
        for p in (1, 2):
            kb = run_pass(kernel, plan_b, ctx, origin, voxel)
            torch.cuda.synchronize()
            with torch.no_grad():
                rb = run_pass(plain, plan_b, ctx, origin, voxel)
            kf = run_pass(kernel, plan_f, ctx, origin, voxel)
            c = bf16_compare(kb, rb)
            bf16_verdict(f"{name} pass {p}", c)
            checks.append(c)
            flips.append(vs_float32(f"{name} pass {p}", kb, kf, voxel))
            if p == 1:
                voxel, origin = _refine_cube(r_specs, kb[0].reshape(n, n, n),
                                             kb[1].reshape(n, n, n), n, voxel)
        del kb, rb, kf
        r = {"check": checks, "vs_float32": flips}

        phase(f"bf16 timing: {name} per {n}^3 pass (bf16 kernel, plain bf16, float32 kernel)")
        if name == "K6":
            runs = {dt: [separate_decoder_inputs(g_specs.latent_size, g_specs.encode_style,
                                                 rows.to(dt))
                         for rows in generic_rows(g_specs, ctx, n, origin0, voxel0, dev)]
                    for dt in (bf16, torch.float32)}

            def timed(fn, plan, dt):
                return lambda: [fn(plan, *rs) for rs in runs[dt]]
        else:
            def timed(fn, plan, dt):
                return lambda: fused_pass(fn, plan, origin0, voxel0)
        bf_ms = min(cuda_ms(timed(kernel, plan_b, bf16), 1) for _ in range(3))
        f32_ms = min(cuda_ms(timed(kernel, plan_f, torch.float32), 1) for _ in range(3))
        with torch.no_grad():
            plain_ms = cuda_ms(timed(plain, plan_b, bf16), 1)
        kernel.launches, kernel.bf16_launches = saved
        if name == "K3":
            sampled = sum(int(pixel_projection(plan_b, s, min(1 << 20, total - s), origin0,
                                               voxel0)[3].sum()) for s in range(0, total, 1 << 20))
            flops = k3_flops(pixel_specs, total, sampled)
            nbytes = 4 * (plan_b.flat.numel() + plan_b.table.numel() + 2 * total)
        elif name == "K6":
            nbytes = (2 * total * (g_specs.latent_size + g_specs.point_feat_size)
                      + 4 * plan_b.flat.numel() + 4 * 2 * total)
            del runs
        else:
            nbytes = 4 * (plan_b.flat.numel() + 2 * total)
        ops_ms = flops / BF16_PEAK_FLOPS * 1e3
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        t = {"ms": bf_ms, "plain_ms": plain_ms, "float32_ms": f32_ms,
             "bound_ms": max(ops_ms, mem_ms), "bound_by": "operations" if ops_ms >= mem_ms
             else "bytes", "split_tf32_bound_ms": grid_bounds(flops, 0)["split_tf32_bound_ms"],
             "tflop": flops / 1e12, "tflops": flops / bf_ms / 1e9}
        r["timing"] = t
        print(f"[{card}] {name} bf16 per {n}^3 pass ({flops / 1e12:.3f} TFLOP): {bf_ms:.2f} ms "
              f"({t['tflops']:.1f} TFLOP/s), plain bf16 {plain_ms:.2f} ms, float32 kernel "
              f"{f32_ms:.2f} ms; bf16 bound {t['bound_ms']:.2f} ms ({t['bound_by']}; the FLOPs "
              f"at {BF16_PEAK_FLOPS / 1e12:g} TFLOP/s dense bf16), split-TF32 bound "
              f"{t['split_tf32_bound_ms']:.2f} ms", flush=True)

        phase(f"bf16 main path, {name}: run_pipelined over {N_IMAGES} images at {n}^3")
        decode_fn = make_generic_decode_fn(g_specs, dtype=bf16) if name == "K6" else None
        r["main_path"] = bf16_main_path(name, r_model, r_specs, samples, dev, card, mano_faces,
                                        kernel, per_image, decode_fn)
        rec[name] = r
        entries.append({
            "name": f"{name} in bf16 (bf16 wgmma)",
            "route": "cuda",
            "source": src,
            "trunk": TC_TRUNK_SOURCE,
            "replaces": line,
            "launches": r["main_path"]["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "share_beyond_1e-5": max(c["share_beyond"] for c in checks),
            "ms": bf_ms,
            "plain_ms": plain_ms,
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "float32_ms": f32_ms,
            "split_tf32_bound_ms": t["split_tf32_bound_ms"],
        })
    del pixel_model, g_model

    phase("bf16 serving: K1 and K3 at 2 + 6 rows on the classifier specs (dexycb --cls), the "
          f"first {n}^3 pass of image 0")
    for name, pixel, kernel, plain, make in (
            ("K1", False, grid_decode, grid_decode_reference,
             lambda s: make_grid_decode_fn(s, n, bf16)),
            ("K3", True, pixel_grid_decode, pixel_grid_decode_reference,
             lambda s: make_pixel_grid_decode_fn(s, n, False, bf16))):
        c_specs = flagship_specs(pixel=pixel, experiment="dexycb_140k.json", classifier=True)
        c_model = build_model(c_specs, device=dev, seed=SEED)
        with torch.no_grad():
            c_model.decoder.classifier_head.weight *= 40  # labels vary, as phase 11's
        plan = make(c_specs)(scene_ctx(c_model, c_specs, samples[0], dev)).plan
        saved = (kernel.launches, kernel.bf16_launches)
        kb = fused_pass(kernel, plan, origin0, voxel0)
        torch.cuda.synchronize()
        with torch.no_grad():
            rb = fused_pass(plain, plan, origin0, voxel0)
        kernel.launches, kernel.bf16_launches = saved
        if plan.n_rows != 2 + c_specs.network_specs.num_class:
            fail(f"{name}'s classifier plan has {plan.n_rows} rows")
        c = bf16_compare(kb, rb)
        bf16_verdict(f"{name} at {plan.n_rows} rows", c)
        rec[name]["classifier_check"] = c
        del c_model, kb, rb
    for e in entries[:2]:
        c = rec[e["name"][:2]]["classifier_check"]
        e["max_abs_err"] = max(e["max_abs_err"], c["max_abs_err"])
        e["logits_max_err_of_largest"] = c["logits_max_err"]

    rec["configs"] = baseline_configs_phase(dev, card, gen, mano_faces)
    return rec, entries


def generic_rows(specs, ctx, n, origin, voxel, dev, run=1 << 18):
    """The [latent, embedding] rows of an n^3 pass, in runs (the generic
    evaluator's)."""
    import torch

    from alignsdf_torch.inference.grid import _coords_from_linear, embed_points

    for s in range(0, n ** 3, run):
        idx = torch.arange(s, min(s + run, n ** 3), device=dev)
        pts = _coords_from_linear(idx, n, origin, voxel)
        yield torch.cat([ctx["latent"].expand(len(idx), -1), embed_points(specs, ctx, pts)],
                        dim=1)


def baseline_configs_phase(dev, card: str, gen, mano_faces, train_steps: int = 0,
                           images: int = N_IMAGES) -> dict:
    """BASELINE.json's configs 1 and 2, served: bare experiments/obman_30k.json
    (NeRF, PointFeatSize 3, no MANO) and the same with --mano, seeded weights
    with shifted final biases: ``images`` synthetic images each at 128^3
    through run_pipelined in float32 and in bf16 (grid_dtype and
    ComputeDtype), K1's launches held to the images' passes; each image's
    two K1 passes (its ctx, the refined cube the Reconstructor reported)
    against K1's plain version; the grid ms and images/s.  With
    ``train_steps`` each dtype's model is first trained that many steps on a
    synthetic batch of ScenesPerBatch through cli/train.make_trainer (K2 in
    that dtype: its launches two a step each way, none of the other dtype's;
    finite losses), then its final biases shifted and served."""
    import numpy as np
    import torch

    from alignsdf_torch.cli.train import make_trainer
    from alignsdf_torch.config import apply_overrides, load_specs
    from alignsdf_torch.data.synthetic import synthetic_train_batch
    from alignsdf_torch.kernels.train_decoder import train_decode, train_decode_backward
    from alignsdf_torch.training.train_step import batch_to_device, draw_seed
    from alignsdf_torch.inference.reconstruct import Reconstructor, make_output_dirs, run_pipelined
    from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.grid_plan import make_grid_decode_fn

    class Mano:
        mano = True

    base = load_specs(os.path.join(REPO, "experiments", "obman_30k.json"))
    n, total, chunk = CUBE_DIM, CUBE_DIM ** 3, 1 << 20
    samples = synthetic_samples(gen, images)
    per_image = 2 * -(-total // chunk)
    rec = {}
    k2 = k2_kernel()
    for cfg, specs in (("config 1 (obman_30k.json)", base),
                       ("config 2 (obman_30k.json --mano)", apply_overrides(base, Mano()))):
        model = build_model(specs, device=dev, seed=SEED)
        shift_final_biases(model, specs, samples[0], dev)
        batch = (batch_to_device(synthetic_train_batch(specs, TRAIN_SCENES, seed=SEED), dev)
                 if train_steps else None)
        for dt in (torch.float32, torch.bfloat16):
            bf = dt == torch.bfloat16
            label = f"{cfg}, {'bf16' if bf else 'float32'}"
            if train_steps:
                phase(f"{label}: {train_steps} train steps at {TRAIN_SCENES} x "
                      f"{specs.samples_per_scene} points through make_trainer (K2 in "
                      f"{'bf16' if bf else 'float32'})")
                s = dataclasses.replace(specs, compute_dtype="bfloat16" if bf else "float32")
                state, step = make_trainer(s, dev, seed=SEED, init_guard=True)
                step_gen = torch.Generator().manual_seed(SEED)
                restore_counts(k2, (0, 0, 0, 0))
                t0 = time.perf_counter()
                totals = [float(step(state, batch, draw_seed(step_gen))["total"])
                          for _ in range(train_steps)]
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) / train_steps * 1e3
                counts = launch_counts(k2)  # f32 fwd, bf16 fwd, f32 bwd, bf16 bwd
                mine, other = (counts[1::2], counts[0::2]) if bf else (counts[0::2], counts[1::2])
                want = (k2.per_step * train_steps,) * 2
                print(f"[{card}] {label}: {train_steps} steps, {step_ms:.2f} ms a step on the "
                      f"host clock (the first included), K2 launches (fwd, bwd) {mine} (expected "
                      f"{want}), the other dtype's {other}; total loss "
                      + ", ".join(f"{t:.5f}" for t in totals), flush=True)
                if tuple(mine) != want or any(other) or not all(np.isfinite(totals)):
                    fail(f"{label}: K2 launches {mine} / {other} or losses {totals}")
                m = state.model.eval()
                shift_final_biases(m, s, samples[0], dev)
                train_rec = {"step_ms": step_ms, "totals": totals,
                             "k2_launches": {"fwd": mine[0], "bwd": mine[1]}}
                del state, step
            else:
                m, s = (model, specs) if dt == torch.float32 else bf16_model(model, specs, dev)
                train_rec = None
            phase(f"{label}: run_pipelined over {images} images at {n}^3, each K1 pass vs "
                  "plain")
            recon = Reconstructor(m, s, cube_dim=n, mano_faces=mano_faces, grid_dtype=dt)
            results = []
            with tempfile.TemporaryDirectory() as out:
                dirs = make_output_dirs(out)
                grid_decode.launches = grid_decode.bf16_launches = 0
                t0 = time.perf_counter()
                done = run_pipelined(recon, samples, dirs,
                                     on_done=lambda i, p: results.append((i, p)))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = (grid_decode.bf16_launches if dt == torch.bfloat16
                            else grid_decode.launches)
                other = (grid_decode.launches if dt == torch.bfloat16
                         else grid_decode.bf16_launches)
            if done != images or launches != images * per_image or other != 0:
                fail(f"{label}: K1 launches {launches} (the other dtype's {other}) over {done} "
                     "images")
            errs, grid_ms = [], []
            saved = (grid_decode.launches, grid_decode.bf16_launches)
            for i, pending in results:
                plan = make_grid_decode_fn(s, n, dt)(pending["ctx"]).plan
                host = pending["host"]
                for origin, voxel in ((torch.full((3,), -1.0, device=dev),
                                       torch.tensor(2.0 / (n - 1), device=dev)),
                                      (host["origin"].to(dev), host["voxel"].to(dev))):
                    out = fused_pass(grid_decode, plan, origin, voxel)
                    torch.cuda.synchronize()
                    errs.append(bf16_compare(out, fused_pass(grid_decode_reference, plan,
                                                             origin, voxel)))
                grid_ms.append(pending["timings"]["grid_ms"])
                if not all(bool(torch.isfinite(host[k]).all()) for k in ("sdf_hand", "sdf_obj")):
                    fail(f"{label} image {i}: non-finite field")
            grid_decode.launches, grid_decode.bf16_launches = saved
            for j, c in enumerate(errs):
                if dt == torch.bfloat16:
                    bf16_verdict(f"{label}, image {j // 2} pass {j % 2 + 1}", c)
                elif not c["max_abs_err"] <= K1_TOL:
                    fail(f"{label}: K1 disagrees with its plain version: {c}")
            r = {"wall_ms": wall * 1e3, "images_per_s": images / wall, "launches": launches,
                 "grid_ms": grid_ms, "max_abs_err": max(c["max_abs_err"] for c in errs),
                 "share_beyond": max(c["share_beyond"] for c in errs), "train": train_rec}
            rec[label] = r
            print(f"[{card}] {label}: {images} images in {wall * 1e3:.1f} ms = "
                  f"{r['images_per_s']:.3f} images/s (first run, pipelined), grid ms "
                  + ", ".join(f"{g:.2f}" for g in grid_ms) + f"; K1 launches {launches}; each "
                  f"pass vs plain: max abs err {r['max_abs_err']:.3e}, share beyond "
                  f"{BF16_TIGHT:g} {r['share_beyond']:.5f}", flush=True)
        del model
    return rec


def bf16_trunk_operands(model, specs, latent, emb):
    """[(prefix, seed, embedding columns, ws, xs, bs)] of a decoder's trunks,
    twin or combined (one trunk of two outputs), folded in the spec's
    compute dtype, detached."""
    import torch

    from alignsdf_torch.models.decoder import trunk_prefixes
    from alignsdf_torch.ops.grid_plan import branch_columns
    from alignsdf_torch.ops.train_plan import trunk_operands

    first, second = trunk_prefixes(model.decoder)
    cols_h, cols_o = branch_columns(specs)
    trunks = [(first, cols_h, 5, 1), (second, cols_o, 6, 1)] if second else [(first, cols_h, 5, 2)]
    out = []
    with torch.no_grad():
        for prefix, cols, seed, out_dim in trunks:
            ws, xs, bs = trunk_operands(model.decoder, prefix, len(cols), latent, specs, out_dim)
            out.append((prefix, seed, emb[:, list(cols)].contiguous(), ws, xs, bs))
    return out


def bf16_train_run(specs, dev, card: str, label: str, kern: TrainKernel,
                   after: Optional[Callable] = None, pixel_band: bool = False) -> dict:
    """A spec's train step at full width through cli/train.make_trainer in
    ``specs``' compute dtype: WARM_STEPS + TIMED_STEPS steps on one
    synthetic batch, each timed on the host clock (synchronized: median and
    range), the train kernel's launches in the dtype's counters
    (``kern.per_step`` a step each way) and none in the other's, finite
    losses, the total falling, the peak device memory; then PROFILED_STEPS
    steps under torch.profiler: device busy and idle share, the kernel's
    forward, chain, reduction and bias-sum ms a step (and none of
    ``kern.absent_kernels`` in the profile).  ``after``, if given,
    is called with the trained state; its result is the record's
    "after".  ``pixel_band``: make_trainer's (cli.train --pixel_band), on
    the batch sorted by its row_sorter."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignsdf_torch.cli.train import make_trainer, row_sorter
    from alignsdf_torch.data.synthetic import synthetic_train_batch
    from alignsdf_torch.training.train_step import batch_to_device, draw_seed

    bf16 = specs.compute_dtype == "bfloat16"
    state, step = make_trainer(specs, dev, seed=SEED, init_guard=True, pixel_band=pixel_band)
    batch = synthetic_train_batch(specs, TRAIN_SCENES, seed=SEED)
    batch = batch_to_device(row_sorter(specs)(batch) if pixel_band else batch, dev)
    gen = torch.Generator().manual_seed(SEED)
    restore_counts(kern, (0, 0, 0, 0))
    totals, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARM_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        totals.append(float(step(state, batch, draw_seed(gen))["total"]))
        torch.cuda.synchronize()
        if i >= WARM_STEPS:
            times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launch_counts(kern)  # f32 fwd, bf16 fwd, f32 bwd, bf16 bwd
    mine, other = (counts[1::2], counts[0::2]) if bf16 else (counts[0::2], counts[1::2])
    n_steps = WARM_STEPS + TIMED_STEPS
    want = (kern.per_step * n_steps,) * 2
    rec = {"step_ms": times, "step_ms_median": float(np.median(times)),
           "step_ms_min_max": [min(times), max(times)], "totals": totals,
           "peak_memory_gb": peak_gb, "launches": {"fwd": mine[0], "bwd": mine[1]}}
    print(f"[{card}] {label}: {n_steps} steps at {TRAIN_SCENES} x {specs.samples_per_scene}, "
          f"steps {WARM_STEPS + 1}-{n_steps} on the host clock median "
          f"{rec['step_ms_median']:.2f} ms ({min(times):.2f}-{max(times):.2f}), peak device "
          f"memory {peak_gb:.2f} GB; {kern.name} launches (fwd, bwd) {mine} (expected {want}), "
          f"the other dtype's {other}; total loss " + ", ".join(f"{t:.5f}" for t in totals),
          flush=True)
    if tuple(mine) != want or any(other):
        fail(f"{label}: {kern.name} launches {mine} (the other dtype's {other}) != {want}")
    if not all(np.isfinite(totals)) or not totals[-1] < totals[0]:
        fail(f"{label}: losses {totals}")
    saved = launch_counts(kern)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(state, batch, draw_seed(gen))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    restore_counts(kern, saved)
    summary = profile_summary(prof, prof_wall)
    if summary is None:
        print(f"{label} profile: not measured (the profiler recorded no device events)",
              flush=True)
    else:
        busy, share, by_kernel = summary
        # the bias sums: colsum, or the db kernel of a chain that takes db
        parts = {"fwd": kern.fwd_kernels, "chain": kern.bwd_kernels[:1],
                 "reduction": kern.bwd_kernels[1:2], "bias_sums": kern.bwd_kernels[2:]}
        per = {k: sum(v for n, v in by_kernel.items() if n.startswith(pre)) / PROFILED_STEPS
               for k, pre in parts.items()}
        per["busy"] = busy / PROFILED_STEPS
        per["rest"] = per["busy"] - sum(per[k] for k in parts)
        rec["profile"] = {"step_wall_ms": prof_wall * 1e3 / PROFILED_STEPS,
                          "idle_share": 1 - share, "per_step_ms": per}
        print(f"[{card}] {label}, {PROFILED_STEPS} profiled steps, "
              f"{prof_wall * 1e3 / PROFILED_STEPS:.2f} ms each: device busy {per['busy']:.2f} "
              f"ms a step, idle share {1 - share:.3f}; {kern.name} fwd {per['fwd']:.2f} ms, chain "
              f"{per['chain']:.2f}, reduction {per['reduction']:.2f}, bias sums "
              f"({', '.join(kern.bwd_kernels[2:])}) {per['bias_sums']:.2f}; the rest (encoder "
              f"fwd+bwd, plan, losses, optimizer) {per['rest']:.2f} ms", flush=True)
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms / PROFILED_STEPS:9.3f} ms/step  {name[:100]}", flush=True)
        absent = sorted({n for n in by_kernel if n.startswith(kern.absent_kernels)}
                        if kern.absent_kernels else ())
        seen = any(n.startswith(kern.bwd_kernels[0]) for n in by_kernel)
        print(f"{label}: {kern.bwd_kernels[0]} {'in' if seen else 'not in'} the profile; "
              f"kernels its route must not launch: {absent or 'none'}", flush=True)
        if absent:
            fail(f"{label}: {kern.name}'s route launched {absent}")
    if after is not None:
        rec["after"] = after(state)
    del state, step
    return rec


def bf16_train_phase(dev, card: str, gen, model, mano_faces) -> Tuple[dict, list]:
    """Phase 20, bf16 training (see the module docstring).  ``model`` is
    phase 5's seeded flagship.  Returns (record, the kernels line's bf16
    training entries: K2 bf16 forward and backward, K7 bf16 forward and
    backward; their launches filled in by main)."""
    import torch

    from alignsdf_torch.kernels.train_decoder import train_decode_forward
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.train_plan import make_train_decoder

    rec = {}
    kern = k2_bf16_kernel()
    specs = flagship_specs()
    specs_b = dataclasses.replace(specs, compute_dtype="bfloat16")
    cls_b = dataclasses.replace(flagship_specs(experiment="dexycb_140k.json", classifier=True),
                                compute_dtype="bfloat16")
    comb_b = dataclasses.replace(specs_b, model_type="1encoder1decoder")
    decoders = {"flagship twin trunks": (model, specs_b, False),
                "DexYCB --cls (x_last)": (build_model(cls_b, device=dev, seed=SEED), cls_b, True),
                "combined trunk": (build_model(comb_b, device=dev, seed=SEED), comb_b, False)}
    rec["check"] = {}
    for name, (m, sp, x_last) in decoders.items():
        st = make_train_decoder(sp).statics
        for scenes in CHECK_SCENES:
            phase(f"K2 bf16 vs plain bf16 ({name}, {scenes} x {sp.samples_per_scene} points, "
                  "full width)")
            latent = (torch.randn(scenes, sp.latent_size, generator=gen) * 0.5).to(dev)
            emb = (torch.randn(scenes * sp.samples_per_scene, sp.point_feat_size,
                               generator=gen) * 0.5).to(dev)
            c = trunk_check(kern, bf16_trunk_operands(m, sp, latent, emb), st, dev, gen, x_last)
            k2_bf16_verdict(c, f"({name}, {scenes} scenes)")
            rec["check"][f"{name}, {scenes}"] = c
    del decoders
    for scenes, nps in K2_BF16_SHORT_SCENES:
        sp = dataclasses.replace(specs_b, samples_per_scene=nps)
        phase(f"K2 bf16 vs plain bf16 (flagship twin trunks, {scenes} x {nps} points: blocks "
              "across scene boundaries)")
        latent = (torch.randn(scenes, sp.latent_size, generator=gen) * 0.5).to(dev)
        emb = (torch.randn(scenes * nps, sp.point_feat_size, generator=gen) * 0.5).to(dev)
        c = trunk_check(kern, bf16_trunk_operands(model, sp, latent, emb),
                        make_train_decoder(sp).statics, dev, gen, False)
        k2_bf16_verdict(c, f"(short scenes, {scenes} x {nps})")
        rec["check"][f"short scenes, {scenes} x {nps}"] = c

    phase(f"K2 bf16 vs float32 K2 on the same operands ({TRAIN_SCENES} x "
          f"{specs.samples_per_scene} points, the flagship's twin trunks)")
    st32 = make_train_decoder(specs).statics
    latent = (torch.randn(TRAIN_SCENES, specs.latent_size, generator=gen) * 0.5).to(dev)
    emb = (torch.randn(TRAIN_SCENES * specs.samples_per_scene, specs.point_feat_size,
                       generator=gen) * 0.5).to(dev)
    saved = launch_counts(kern)
    diff = 0.0
    with torch.no_grad():
        for _, seed, e, ws, xs, bs in k2_operands(model, specs, latent, emb):
            pack_b = kern.pack(e, ws, xs, bs, st32._replace(dtype=torch.bfloat16))
            yb, _ = train_decode_forward(pack_b, seed, st32)
            yf, _ = train_decode_forward(kern.pack(e, ws, xs, bs, st32), seed, st32)
            diff = max(diff, float((yb - yf).abs().max()))
    restore_counts(kern, saved)
    rec["vs_float32_max_abs_diff"] = diff
    print(f"K2 bf16 vs float32 K2: y max abs diff {diff:.3e} (tolerance {BF16_VS_F32_TOL:g}, "
          "JAX's bf16 bound)", flush=True)
    if not 0 < diff <= BF16_VS_F32_TOL:
        fail(f"K2 bf16's y is {diff} from float32 K2's")

    phase("K7 bf16 vs plain: the stem max pool on bf16 at the train and odd shapes")
    rec["k7"] = k7_phase(dev, card, torch.bfloat16,
                         {k: K7_SHAPES[k] for k in ("train", "odd")})

    rec["train"] = {}
    for label, sp, k in (("flagship bf16 (cli.train --bf16's trainer)", specs_b, kern),
                         ("flagship float32 (the same call)", specs, k2_kernel())):
        phase(f"training: {label}, {WARM_STEPS} warm-up + {TIMED_STEPS} timed steps, "
              f"{PROFILED_STEPS} profiled")
        rec["train"][label.split(" (")[0]] = bf16_train_run(sp, dev, card, label, k)
    b, f = rec["train"]["flagship bf16"], rec["train"]["flagship float32"]
    print(f"[{card}] flagship train step, bf16 / float32 in one call: median "
          f"{b['step_ms_median']:.2f} / {f['step_ms_median']:.2f} ms on the host clock, peak "
          f"memory {b['peak_memory_gb']:.2f} / {f['peak_memory_gb']:.2f} GB", flush=True)

    phase(f"timing: K2 bf16 forward and backward per step ({TRAIN_SCENES} x "
          f"{specs.samples_per_scene} points, both trunks)")
    st_b = make_train_decoder(specs_b).statics
    latent = (torch.randn(TRAIN_SCENES, specs.latent_size, generator=gen) * 0.5).to(dev)
    emb = (torch.randn(TRAIN_SCENES * specs.samples_per_scene, specs.point_feat_size,
                       generator=gen) * 0.5).to(dev)
    rec["timing"] = trunk_timing(kern, k2_operands(model, specs_b, latent, emb), st_b, dev, gen,
                                 card, False)

    rec["configs"] = baseline_configs_phase(dev, card, gen, mano_faces,
                                            train_steps=CONFIG_TRAIN_STEPS, images=1)
    entries = []
    for name, line in (("fwd", 472), ("bwd", 652)):
        t = rec["timing"][name]
        entries.append({
            "name": f"K2 bf16 scene-factored train decoder, "
                    f"{'forward' if name == 'fwd' else 'backward'}",
            "route": "cuda",
            "source": "alignsdf_torch/kernels/csrc/train_decoder.cu",
            "replaces": f"alignsdf_tpu/ops/decoder_train_kernel.py:{line}",
            "launches": 0,
            "max_abs_err": max(c["y_max_abs_err" if name == "fwd" else "grad_max_abs_err"]
                               for c in rec["check"].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            **({"trunk": FWD_SOURCE} if name == "fwd" else backward_entry(t)),
        })
    for name, line in (("fwd", 122), ("bwd", 140)):
        t = rec["k7"]["train"]["timing"][name]
        entries.append({
            "name": "K7 bf16 stem max pool 3x3/s2/p1, "
                    + ("forward" if name == "fwd" else "backward"),
            "route": "cuda",
            "source": "alignsdf_torch/kernels/csrc/maxpool.cu",
            "replaces": f"alignsdf_tpu/ops/maxpool.py:{line}",
            "launches": 0,
            "max_abs_err": max(rec["k7"][k]["fwd_max_abs_err" if name == "fwd"
                                            else "grad_max_abs_err"] for k in ("train", "odd")),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": ("F.max_pool2d on bf16" if name == "fwd" else
                        "max_pool2d_with_indices_backward on bf16 (a tied window's gradient to "
                        "its first maximum, not to every tie)"),
        })
    return rec, entries


def k4_bf16_kernel() -> TrainKernel:
    """K4 on a bf16 pack: the same wrappers, counted by their bf16_launches
    (``launch_counts``); its plain version is the plain bf16 one (the
    statics' dtype)."""
    return k4_kernel()._replace(name="K4 bf16", fwd_kernels=K4_BF16_FWD_KERNELS,
                                bwd_kernels=K4_BF16_BWD_KERNELS, grad_rtol=BF16_GRAD_RTOL)


def k5_bf16_kernel() -> TrainKernel:
    """K5 on a bf16 pack, as k4_bf16_kernel."""
    return k5_kernel()._replace(name="K5 bf16", fwd_kernels=K5_BF16_FWD_KERNELS,
                                bwd_kernels=K5_BF16_BWD_KERNELS, grad_rtol=BF16_GRAD_RTOL)


def serve_cli(specs, state, dev, card: str, label: str, gen, bf16: bool) -> dict:
    """A trained model served through cli.reconstruct.main, with --bf16
    where ``bf16`` (its ComputeDtype bfloat16 in specs.json): SERVE_IMAGES
    synthetic images at CUBE_DIM^3, the grid's kernel (K3 for a
    pixel-aligned spec, else K1) on its plan of that dtype: its launches
    (the bf16 kernel's, or the float32 one's) two passes an image in runs
    of 2^20 points, none of the other; each image's timings."""
    import numpy as np
    import torch

    from alignsdf_torch.cli import reconstruct as reconstruct_cli
    from alignsdf_torch.config import specs_to_dict
    from alignsdf_torch.kernels.grid_decoder import grid_decode
    from alignsdf_torch.kernels.pixel_grid_decoder import pixel_grid_decode
    from alignsdf_torch.training import checkpoints as ckpt

    kernel, kname = (pixel_grid_decode, "K3") if specs.pixel_align else (grid_decode, "K1")
    samples = synthetic_samples(gen, SERVE_IMAGES)
    with tempfile.TemporaryDirectory() as exp:
        with open(os.path.join(exp, "specs.json"), "w") as f:
            json.dump(specs_to_dict(specs), f, indent=2)
        ckpt.save_checkpoint(exp, state, state.epoch, "latest")
        path = os.path.join(exp, "samples.npz")
        np.savez(path, **{k: np.stack([s[k] for s in samples]) for k in samples[0]})
        kernel.launches = kernel.bf16_launches = 0
        t0 = time.perf_counter()
        per_image = reconstruct_cli.main(["-e", exp, "--samples", path, "--cube_dim",
                                          str(CUBE_DIM), "--device", dev.type]
                                         + (["--bf16"] if bf16 else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meshes = sorted(os.listdir(os.path.join(exp, "Eval_obman", "meshes"))) \
            if os.path.isdir(os.path.join(exp, "Eval_obman", "meshes")) else []
    want = SERVE_IMAGES * 2 * -(-CUBE_DIM ** 3 // (1 << 20))
    launches, other = ((kernel.bf16_launches, kernel.launches) if bf16
                       else (kernel.launches, kernel.bf16_launches))
    how, mine, theirs = ("--bf16", "bf16", "float32") if bf16 else ("", "float32", "bf16")
    print(f"[{card}] {label} served by cli.reconstruct {how}: {SERVE_IMAGES} image(s) at "
          f"{CUBE_DIM}^3 in {wall:.2f} s, {kname} {mine} launches {launches} (expected {want}), "
          f"{theirs} {other}; meshes written {meshes}", flush=True)
    for t in per_image:
        print(f"  {t['key']}: " + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in t.items()
                                            if k != "key") + " ms", flush=True)
    if launches != want or other != 0 or len(per_image) != SERVE_IMAGES:
        fail(f"{label} {how} serving: {kname} {mine} launches {launches} != {want} ({theirs} "
             f"{other})")
    if not all(np.isfinite(v) for t in per_image for k, v in t.items() if k != "key"):
        fail(f"{label} {how} serving: a non-finite timing {per_image}")
    return {"kernel": kname, "launches": launches, "wall_s": wall, "images": per_image,
            "meshes": meshes}


def bf16_pixel_generic_phase(dev, card: str, gen) -> Tuple[dict, list]:
    """Phase 21, bf16 training through K4 and K5 (see the module docstring).
    Returns (record, the kernels line's entries: K4 bf16 forward and
    backward, K5 bf16 forward and backward; their launches filled in by
    main)."""
    import torch

    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder

    bf = lambda sp: dataclasses.replace(sp, compute_dtype="bfloat16")  # noqa: E731
    pix = flagship_specs(pixel=True)
    pcls = flagship_specs(pixel=True, experiment="dexycb_140k.json", classifier=True)
    gen0 = latent_in_0_specs()
    k4b, k5b = k4_bf16_kernel(), k5_bf16_kernel()
    rec = {"check": {}}
    for name, sp, x_last in (("--pa_feat", bf(pix), False),
                             ("--pa_feat --cls (x_last)", bf(pcls), True)):
        model = build_model(sp, device=dev, seed=SEED)
        for scenes in CHECK_SCENES:
            phase(f"K4 bf16 vs plain bf16 ({name}, {scenes} x {sp.samples_per_scene} points, "
                  "full width, the HeadNet map and projection of a synthetic batch)")
            inputs, trunks, st, _ = k4_operands(model, sp, dev, scenes)
            c = k4_check(inputs, trunks, st, dev, gen, x_last)
            print(f"K4 bf16 latent vs plain {c['latent_max_abs_err']:.3e}; in-image share "
                  f"{c['in_image_share']:.4f}", flush=True)
            k2_bf16_verdict(c, f"({name}, {scenes} scenes)", "K4 bf16", BF16_RESID_SHARE_DEEP)
            print(f"K4 bf16 sampling gradients (table, mean, xp, yp): "
                  f"{c['sampling_grad_share_tight']:.6f} of the entries within {BF16_GRAD_RTOL:g} "
                  f"of the largest, max {c['sampling_grad_max_rel_err']:.3e} (tolerance "
                  f"{BF16_SAMPLING_GRAD_RTOL:.3e}); by gradient " + ", ".join(
                      f"{k} {v:.2e}" for k, v in list(c["grad_rel_err"].items())[:5]), flush=True)
            if not (c["sampling_grad_share_tight"] >= BF16_SAMPLING_SHARE
                    and c["sampling_grad_max_rel_err"] <= BF16_SAMPLING_GRAD_RTOL):
                fail(f"K4 bf16's sampling gradients disagree with the plain bf16 backward "
                     f"({name}, {scenes} scenes)")
            if not 0.0 < c["in_image_share"] < 1.0:
                fail(f"the in-image share {c['in_image_share']} must lie strictly between 0 "
                     "and 1")
            rec["check"][f"K4 {name}, {scenes}"] = c
        del model
    model = build_model(bf(gen0), device=dev, seed=SEED)
    st5 = make_generic_train_decoder(bf(gen0)).statics
    for scenes in CHECK_SCENES:
        phase(f"K5 bf16 vs plain bf16 (latent_in (0, 2), {scenes} x {gen0.samples_per_scene} "
              "rows of 256 + 6, both trunks, nonzero dy and dx_last)")
        trunks = k5_operands(model, bf(gen0), k5_rows(gen0, dev, gen, scenes))
        c = trunk_check(k5b, trunks, st5, dev, gen, True)
        k2_bf16_verdict(c, f"(latent_in (0, 2), {scenes} scenes)", "K5 bf16",
                        BF16_RESID_SHARE_DEEP)
        rec["check"][f"K5, {scenes}"] = c
    del model

    rec["train"], rec["served"] = {}, {}
    for label, sp, kb, kf in (("--pa_feat", pix, k4b, k4_kernel()),
                              ("--pa_feat --cls", pcls, k4b, k4_kernel()),
                              ("latent_in (0, 2)", gen0, k5b, k5_kernel())):
        for key, how, s, k in (("bf16", "cli.train --bf16's trainer", bf(sp), kb),
                               ("float32", "the same call", sp, kf)):
            dt_label = f"{label} {key} ({how})"
            phase(f"training: {dt_label}, {WARM_STEPS} warm-up + {TIMED_STEPS} timed steps, "
                  f"{PROFILED_STEPS} profiled")
            serve = ((lambda state, s=s, lb=label: serve_cli(s, state, dev, card, lb, gen, True))
                     if key == "bf16" else None)
            rec["train"][f"{label} {key}"] = bf16_train_run(s, dev, card, dt_label, k,
                                                            after=serve)
        b, f = rec["train"][f"{label} bf16"], rec["train"][f"{label} float32"]
        rec["served"][label] = b.pop("after")
        busy = [r.get("profile", {}).get("per_step_ms", {}).get("busy") for r in (b, f)]
        idle = [r.get("profile", {}).get("idle_share") for r in (b, f)]
        print(f"[{card}] {label} train step, bf16 / float32 in one call: median "
              f"{b['step_ms_median']:.2f} / {f['step_ms_median']:.2f} ms on the host clock, "
              f"device busy {busy[0]} / {busy[1]} ms a step, idle share {idle[0]} / {idle[1]}, "
              f"peak memory {b['peak_memory_gb']:.2f} / {f['peak_memory_gb']:.2f} GB", flush=True)

    phase(f"timing: K4 bf16 forward and backward per step ({TRAIN_SCENES} x "
          f"{pix.samples_per_scene} points, both trunks); F.grid_sample on bf16 at the same points")
    model = build_model(bf(pix), device=dev, seed=SEED)
    inputs, trunks, st, (fmap, uv) = k4_operands(model, bf(pix), dev, TRAIN_SCENES)
    rec["k4_timing"] = k4_timing(inputs, trunks, st, fmap, uv, dev, gen, card)
    del model, inputs, trunks, fmap, uv
    phase(f"timing: K5 bf16 forward and backward per step ({TRAIN_SCENES} x "
          f"{gen0.samples_per_scene} rows, both trunks)")
    model = build_model(bf(gen0), device=dev, seed=SEED)
    rec["k5_timing"] = trunk_timing(k5b, k5_operands(model, bf(gen0),
                                                     k5_rows(gen0, dev, gen, TRAIN_SCENES)),
                                    st5, dev, gen, card, False)
    del model

    entries = []
    for kname, key, source, replaces, lib in (
            ("K4", "k4_timing", "alignsdf_torch/kernels/csrc/pixel_train_decoder.cu",
             "alignsdf_tpu/ops/decoder_train_pixel.py:{}", True),
            ("K5", "k5_timing", "alignsdf_torch/kernels/csrc/generic_train_decoder.cu",
             "alignsdf_tpu/ops/decoder_train_kernel.py:{}", False)):
        checks = [c for k, c in rec["check"].items() if k.startswith(kname)]
        lines = (335, 647) if kname == "K4" else (142, 286)
        for part, line in zip(("fwd", "bwd"), lines):
            t = rec[key][part]
            err = max(max(c["y_max_abs_err"], c["x_last_max_abs_err"]) if part == "fwd"
                      else c["grad_max_abs_err"] for c in checks)
            entries.append({
                "name": f"{kname} bf16 {'pixel' if kname == 'K4' else 'generic'} train decoder, "
                        f"{'forward' if part == 'fwd' else 'backward'}",
                "route": "cuda", "source": source, "replaces": replaces.format(line),
                "launches": 0, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"] if lib else None,
                **({"library_call": f"F.grid_sample bicubic on bf16, "
                                    f"{'forward' if part == 'fwd' else 'backward'}, at the "
                                    "step's points (the sampling step only)"} if lib else {}),
                **({"trunk": FWD_SOURCE} if part == "fwd" else backward_entry(t)),
            })
    return rec, entries


def final_latent_specs(pixel: bool = False, zero: bool = False):
    """The flagship (with --pa_feat where ``pixel``) whose NetworkSpecs
    latent_in names the final layer: FINAL_LATENT_IN, or with ``zero``
    FINAL_LATENT_IN_0 (layer 0 too, so that K5 trains it)."""
    specs = flagship_specs(pixel=pixel)
    return dataclasses.replace(specs, network_specs=dataclasses.replace(
        specs.network_specs, latent_in=FINAL_LATENT_IN_0 if zero else FINAL_LATENT_IN))


def final_latent_check(kname: str, model, sp, dev, gen, scenes: int) -> dict:
    """The train kernel ``kname`` (K2, K4 or K5) of a final-latent spec
    against its plain version (in the spec's dtype) at scenes x 2000
    points, the first trunk's backward with a random dx_last: K2 on random
    latents and embeddings, K4 on the HeadNet map and projection of a
    synthetic batch, K5 on materialized rows."""
    import torch

    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder
    from alignsdf_torch.ops.train_plan import make_train_decoder

    bf16 = sp.compute_dtype == "bfloat16"
    if kname == "K4":
        inputs, trunks, st, _ = k4_operands(model, sp, dev, scenes)
        return k4_check(inputs, trunks, st, dev, gen, True)
    if kname == "K2":
        latent = (torch.randn(scenes, sp.latent_size, generator=gen) * 0.5).to(dev)
        emb = (torch.randn(scenes * sp.samples_per_scene, sp.point_feat_size,
                           generator=gen) * 0.5).to(dev)
        return trunk_check(k2_bf16_kernel() if bf16 else k2_kernel(),
                           k2_operands(model, sp, latent, emb),
                           make_train_decoder(sp).statics, dev, gen, True)
    return trunk_check(k5_bf16_kernel() if bf16 else k5_kernel(),
                       k5_operands(model, sp, k5_rows(sp, dev, gen, scenes)),
                       make_generic_train_decoder(sp).statics, dev, gen, True)


def final_latent_verdict(kname: str, c: dict, label: str, bf16: bool) -> None:
    """Fail unless a final-latent check holds the bounds of the kernel's
    default spec: float32 y, x_last and every gradient within 1e-4 (K2, K5
    also of float64's), the forward's residuals (forward_verdict), the kept
    shares and the gating; bf16 phases 20-21's (K4's and K5's deep
    residual share, K4's sampling gradients)."""
    name = f"{kname} bf16" if bf16 else kname
    if kname == "K4":
        print(f"{name} latent vs plain {c['latent_max_abs_err']:.3e}; in-image share "
              f"{c['in_image_share']:.4f}; worst gradients " + ", ".join(
                  f"{k} {v:.2e}" for k, v in sorted(c["grad_rel_err"].items(),
                                                     key=lambda kv: -kv[1])[:4]), flush=True)
        if not 0.0 < c["in_image_share"] < 1.0:
            fail(f"the in-image share {c['in_image_share']} must lie strictly between 0 and 1")
    if bf16:
        k2_bf16_verdict(c, label, name, BF16_RESID_SHARE if kname == "K2"
                        else BF16_RESID_SHARE_DEEP)
        if kname == "K4":
            print(f"{name} sampling gradients: {c['sampling_grad_share_tight']:.6f} within "
                  f"{BF16_GRAD_RTOL:g} of the largest, max {c['sampling_grad_max_rel_err']:.3e} "
                  f"(tolerance {BF16_SAMPLING_GRAD_RTOL:.3e}); d(table) against the plain bf16 "
                  f"backward in float64: kernel {c['dtable_f64_rel_err']['kernel']:.3e}, plain "
                  f"{c['dtable_f64_rel_err']['plain']:.3e} of the largest", flush=True)
            if not (c["sampling_grad_share_tight"] >= BF16_SAMPLING_SHARE
                    and c["sampling_grad_max_rel_err"] <= BF16_SAMPLING_GRAD_RTOL):
                fail(f"{name}'s sampling gradients disagree with the plain bf16 backward {label}")
        return
    tol = K4_TOL if kname == "K4" else K2_TOL
    print(f"{name} y max abs err {c['y_max_abs_err']:.3e}, x_last "
          f"{c['x_last_max_abs_err']:.3e} (tolerance {tol:g}); {forward_text(c)}; gradients max "
          f"err {c['grad_max_abs_err']:.3e} abs, {c['grad_max_rel_err']:.3e} of the largest"
          + (f", {c['grad_f64_max_rel_err']:.3e} of float64's" if "grad_f64_max_rel_err" in c
             else "") + f"; kept share {c['kept_share']}; residual sign mismatch "
          f"{c['residual_sign_mismatch']:.2e}", flush=True)
    if not (c["y_max_abs_err"] <= tol and c["x_last_max_abs_err"] <= tol
            and c["grad_max_rel_err"] <= tol and c.get("grad_f64_max_rel_err", 0.0) <= tol):
        fail(f"{name} disagrees with its plain version {label}")
    forward_verdict(c, name, tol)
    if len(c["kept_share"]) != 8 or not all(abs(v - 0.8) <= 0.01
                                            for v in c["kept_share"].values()):
        fail(f"kept shares off 0.8 +- 0.01 {label}: {c['kept_share']}")
    if not c["residual_sign_mismatch"] <= 1e-4:
        fail(f"{name}'s residuals are not gated as the plain version's {label}")


def final_latent_grid(specs, state, dev, card: str, label: str, gen) -> dict:
    """A trained final-latent model's grid kernel (K3 for the --pa_feat
    spec: its final rows read the latent a third time; else K1, whose final
    rows take the folded latent as a bias and fin_x) on the trained weights
    in the spec's compute dtype: one 128^3 pass of a synthetic image against
    its plain version (float32 within K1_TOL / K3_TOL, bf16
    bf16_verdict's), K3's pass timed beside its plain version, its bound and
    F.grid_sample.  Then the model served by cli.reconstruct (serve_cli)."""
    import torch
    import torch.nn.functional as F

    from alignsdf_torch.inference.grid import _coords_from_linear
    from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference
    from alignsdf_torch.kernels.pixel_grid_decoder import (
        pixel_grid_decode, pixel_grid_decode_reference, pixel_projection)
    from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
    from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

    bf16 = specs.compute_dtype == "bfloat16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    pixel = specs.pixel_align
    kname = "K3" if pixel else "K1"
    kernel, plain = ((pixel_grid_decode, pixel_grid_decode_reference) if pixel
                     else (grid_decode, grid_decode_reference))
    n, total = CUBE_DIM, CUBE_DIM ** 3
    origin = torch.full((3,), -1.0, device=dev)
    voxel = torch.tensor(2.0 / (n - 1), device=dev)
    state.model.eval()
    with torch.no_grad():
        ctx = scene_ctx(state.model, specs, synthetic_samples(gen, 1)[0], dev)
        plan = (make_pixel_grid_decode_fn(specs, n, False, dtype) if pixel
                else make_grid_decode_fn(specs, n, dtype))(ctx).plan
    if pixel and any(f is None for f in plan.fin_lats()):
        fail(f"{label}: K3's plan carries no final latent weights")
    saved = kernel.launches, kernel.bf16_launches
    out = fused_pass(kernel, plan, origin, voxel)
    ref = fused_pass(plain, plan, origin, voxel)
    rec = {"kernel": kname}
    if bf16:
        c = bf16_compare(out, ref)
        bf16_verdict(f"{label}, {kname} on the trained weights at {n}^3", c)
        rec.update(c)
    else:
        err = float((out - ref).abs().max())
        tol = K3_TOL if pixel else K1_TOL
        print(f"{label}: {kname} on the trained weights vs its plain version over a {n}^3 pass: "
              f"max abs err {err:.3e} (tolerance {tol:g})", flush=True)
        if not err <= tol:
            fail(f"{label}: {kname} disagrees with its plain version on the trained weights")
        rec["max_abs_err"] = err
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: {kname}'s field is not finite")
    if pixel:
        runs = [cuda_ms(lambda: fused_pass(kernel, plan, origin, voxel), 1) for _ in range(3)]
        plain_ms = cuda_ms(lambda: fused_pass(plain, plan, origin, voxel), 1)
        xyz_cam = (_coords_from_linear(torch.arange(total, device=dev), n, origin, voxel) * 2.0
                   / specs.sdf_scale_factor + ctx["pred_root"][0])
        hom = xyz_cam @ ctx["cam_intr"][0, :3, :3].T
        uv = (hom[:, :2] / hom[:, 2:3] / specs.image_size[0] * 2.0 - 1.0)[None, None].to(dtype)
        fm = ctx["latent"].to(dtype)
        lib_ms = cuda_ms(lambda: F.grid_sample(fm, uv, mode="bicubic", align_corners=True,
                                               padding_mode="zeros"), 3)
        sampled = sum(int(pixel_projection(plan, s, min(1 << 20, total - s), origin, voxel)[3]
                          .sum()) for s in range(0, total, 1 << 20))
        flops = k3_flops(specs, total, sampled)
        nbytes = 4 * (plan.flat.numel() + plan.table.numel() + 2 * total)
        best = min(runs)
        rec["timing"] = {"ms": best, "ms_runs": runs, "plain_ms": plain_ms, "library_ms": lib_ms,
                         **train_bounds(flops, nbytes, bf16), "tflop": flops / 1e12,
                         "in_image_points": sampled, "tflops": flops / best / 1e9}
        print(f"[{card}] {label}: K3{' bf16' if bf16 else ''} with the final latent per {n}^3 "
              f"pass ({sampled} points in the image, {flops / 1e12:.3f} TFLOP): "
              + " / ".join(f"{t:.2f}" for t in runs) + f" ms, plain {plain_ms:.2f} ms, "
              f"{bounds_text(rec['timing'])}; F.grid_sample (sampling only) {lib_ms:.2f} ms",
              flush=True)
    kernel.launches, kernel.bf16_launches = saved
    rec["served"] = serve_cli(specs, state, dev, card, label, gen, bf16)
    return rec


def final_latent_phase(dev, card: str, gen, defaults: dict) -> Tuple[dict, list]:
    """Phase 22, a latent input at the final layer (see the module
    docstring).  ``defaults`` holds the default specs' train timings (K2,
    K4, K5 and their bf16, from the earlier phases), beside which each new
    variant's are printed.  Returns (record, the kernels line's entries:
    K2, K4 and K5 forward and backward and K3's pass, each in float32 and
    bf16)."""
    import torch

    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder
    from alignsdf_torch.ops.train_plan import make_train_decoder
    from alignsdf_torch.training.train_step import make_train_step, train_decoder_kind

    bf = lambda sp: dataclasses.replace(sp, compute_dtype="bfloat16")  # noqa: E731
    variants = (("K2", f"latent_in {FINAL_LATENT_IN}", final_latent_specs(),
                 k2_bf16_kernel(), k2_kernel()),
                ("K4", f"--pa_feat latent_in {FINAL_LATENT_IN}", final_latent_specs(pixel=True),
                 k4_bf16_kernel(), k4_kernel()),
                ("K5", f"latent_in {FINAL_LATENT_IN_0}", final_latent_specs(zero=True),
                 k5_bf16_kernel(), k5_kernel()))
    rec = {"check": {}, "train": {}, "served": {}, "timing": {}}
    for kname, label, sp, _, _ in variants:
        for s in (sp, bf(sp)):
            kind = train_decoder_kind(make_train_step(s).decode)
            if f"({kname})" not in kind:
                fail(f"{label} ({s.compute_dtype}) routed to {kind}, not {kname}")
        model = build_model(sp, device=dev, seed=SEED)
        for scenes, s in ((4, sp), (TRAIN_SCENES, sp), (TRAIN_SCENES, bf(sp))):
            bf16 = s.compute_dtype == "bfloat16"
            phase(f"final latent: {kname}{' bf16' if bf16 else ''} vs plain ({label}, {scenes} x "
                  f"{s.samples_per_scene} points, both trunks, full width, nonzero dy and "
                  "dx_last, TF32 off)")
            c = final_latent_check(kname, model, s, dev, gen, scenes)
            final_latent_verdict(kname, c, f"({label}, {scenes} scenes)", bf16)
            rec["check"][f"{kname}{' bf16' if bf16 else ''}, {scenes}"] = c
        del model

    for kname, label, sp, kb, kf in variants:
        for key, s, k in (("bf16", bf(sp), kb), ("float32", sp, kf)):
            how = "cli.train --bf16's trainer" if key == "bf16" else "cli.train's trainer"
            dt_label = f"{label} {key} ({how})"
            phase(f"final latent training: {dt_label}, {WARM_STEPS} warm-up + {TIMED_STEPS} timed "
                  f"steps, {PROFILED_STEPS} profiled; then its grid kernel on the trained weights "
                  f"and cli.reconstruct at {CUBE_DIM}^3")
            r = bf16_train_run(s, dev, card, dt_label, k,
                               after=lambda state, s=s, lb=f"{label} {key}": final_latent_grid(
                                   s, state, dev, card, lb, gen))
            rec["served"][f"{label} {key}"] = r.pop("after")
            rec["train"][f"{label} {key}"] = r

    for kname, label, sp, kb, kf in variants:
        for s, k in ((sp, kf), (bf(sp), kb)):
            bf16 = s.compute_dtype == "bfloat16"
            name = f"{kname} bf16" if bf16 else kname
            phase(f"final latent timing: {name} forward and backward per step ({label}, "
                  f"{TRAIN_SCENES} x {s.samples_per_scene} points, both trunks)")
            model = build_model(s, device=dev, seed=SEED)
            if kname == "K4":
                inputs, trunks, st, (fmap, uv) = k4_operands(model, s, dev, TRAIN_SCENES)
                t = k4_timing(inputs, trunks, st, fmap, uv, dev, gen, card)
                del inputs, trunks, fmap, uv
            elif kname == "K2":
                latent = (torch.randn(TRAIN_SCENES, s.latent_size, generator=gen) * 0.5).to(dev)
                emb = (torch.randn(TRAIN_SCENES * s.samples_per_scene, s.point_feat_size,
                                   generator=gen) * 0.5).to(dev)
                t = trunk_timing(k, k2_operands(model, s, latent, emb),
                                 make_train_decoder(s).statics, dev, gen, card, False)
            else:
                t = trunk_timing(k, k5_operands(model, s, k5_rows(s, dev, gen, TRAIN_SCENES)),
                                 make_generic_train_decoder(s).statics, dev, gen, card, False)
            del model
            base = defaults.get(name)
            for part in ("fwd", "bwd"):
                if base is not None:
                    t[part]["default_spec_ms"] = base[part]["ms"]
                print(f"[{card}] {name} {part} with the final latent ({label}): "
                      f"{t[part]['ms']:.2f} ms against the default spec's "
                      + (f"{base[part]['ms']:.2f} ms ({t[part]['ms'] / base[part]['ms']:.3f}x)"
                         if base is not None else "(not measured)")
                      + f", bound {t[part]['bound_ms']:.2f} ms "
                      f"({t[part]['ms'] / t[part]['bound_ms']:.2f}x)", flush=True)
            rec["timing"][name] = t

    entries = []
    lines = {"K2": ("alignsdf_tpu/ops/decoder_train_kernel.py:{}", (472, 652),
                    "alignsdf_torch/kernels/csrc/train_decoder.cu", "scene-factored"),
             "K4": ("alignsdf_tpu/ops/decoder_train_pixel.py:{}", (335, 647),
                    "alignsdf_torch/kernels/csrc/pixel_train_decoder.cu", "pixel"),
             "K5": ("alignsdf_tpu/ops/decoder_train_kernel.py:{}", (142, 286),
                    "alignsdf_torch/kernels/csrc/generic_train_decoder.cu", "generic")}
    for kname, label, sp, kb, kf in variants:
        replaces, (lf, lb), source, what = lines[kname]
        for bf16, k in ((False, kf), (True, kb)):
            name = f"{kname} bf16" if bf16 else kname
            key = f"{label} {'bf16' if bf16 else 'float32'}"
            checks = [c for ck, c in rec["check"].items()
                      if ck.startswith(name + ",")]
            for part, line in (("fwd", lf), ("bwd", lb)):
                t = rec["timing"][name][part]
                err = max(max(c["y_max_abs_err"], c["x_last_max_abs_err"]) if part == "fwd"
                          else c["grad_max_abs_err"] for c in checks)
                entries.append({
                    "name": f"{name} {what} train decoder with a final-layer latent input "
                            f"({label}), {'forward' if part == 'fwd' else 'backward'}",
                    "route": "cuda", "source": source, "replaces": replaces.format(line),
                    "launches": rec["train"][key]["launches"][part], "max_abs_err": err,
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"] if kname == "K4" else None,
                    **({"library_call": f"F.grid_sample bicubic{' on bf16' if bf16 else ''}, "
                                        f"{'forward' if part == 'fwd' else 'backward'}, at the "
                                        "step's points (the sampling step only)"}
                       if kname == "K4" else {}),
                    "default_spec_ms": t.get("default_spec_ms"),
                    **({"trunk": FWD_SOURCE} if part == "fwd" else backward_entry(t)),
                })
    pix_label = variants[1][1]
    for key in ("float32", "bf16"):
        g = rec["served"][f"{pix_label} {key}"]
        t = g["timing"]
        entries.append({
            "name": f"K3{' bf16' if key == 'bf16' else ''} fused pixel grid decoder with a "
                    f"final-layer latent input ({pix_label}), per {CUBE_DIM}^3 pass",
            "route": "cuda", "source": "alignsdf_torch/kernels/csrc/pixel_grid_decoder.cu",
            "trunk": TC_TRUNK_SOURCE, "replaces": "alignsdf_tpu/ops/decoder_kernel.py:884",
            "launches": g["served"]["launches"],
            "max_abs_err": g["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": "F.grid_sample bicubic at the pass's points (the sampling step only)",
        })
    return rec, entries


class _BandCounts:
    """The banded backward's launch counters (``band_launches``,
    ``band_bf16_launches``) under the names ``launch_counts`` and
    ``restore_counts`` read and write."""

    def __init__(self, fn):
        self.__dict__["fn"] = fn

    launches = property(lambda self: self.fn.band_launches,
                        lambda self, v: setattr(self.fn, "band_launches", v))
    bf16_launches = property(lambda self: self.fn.band_bf16_launches,
                             lambda self, v: setattr(self.fn, "band_bf16_launches", v))


def k4_band_kernel(bf16: bool = False) -> TrainKernel:
    """K4 with a band (cli.train --pixel_band): its backward counted by the
    banded route's counters."""
    from alignsdf_torch.kernels.pixel_train_decoder import pixel_train_decode_backward

    kern = k4_bf16_kernel() if bf16 else k4_kernel()
    return kern._replace(name=kern.name.replace("K4", "K4 band"),
                         bwd=_BandCounts(pixel_train_decode_backward))


def unbanded_bwd_counts() -> Tuple[int, int]:
    from alignsdf_torch.kernels.pixel_train_decoder import pixel_train_decode_backward as b

    return b.launches, b.bf16_launches


def band_counts() -> Tuple[int, int]:
    from alignsdf_torch.kernels.pixel_train_decoder import pixel_train_decode_backward as b

    return b.band_launches, b.band_bf16_launches


def set_band_counts(saved: Tuple[int, int]) -> None:
    from alignsdf_torch.kernels.pixel_train_decoder import pixel_train_decode_backward as b

    b.band_launches, b.band_bf16_launches = saved


def row_sorted(inputs, scenes: int):
    """K4's operands with each scene's points sorted by their own yp (the
    plan's device sort, ``sort_by_row``): the table and the mean as they
    are, xp, yp, mask and the embedding permuted."""
    from alignsdf_torch.ops.pixel_train_plan import sort_by_row

    table, mean, xp, yp, mask, emb = inputs
    perm, _ = sort_by_row(yp, mask, scenes)
    return table, mean, xp[perm], yp[perm], mask[perm], emb[perm]


def fit_share(inputs, n: int, hf: int, band: int) -> dict:
    """The band's fits on these operands (``tile_band_bounds``): the share
    of the live scene segments of the 64-point tiles that fit, and of the
    tiles whose live segments all do."""
    import torch

    from alignsdf_torch.kernels.pixel_train_decoder import tile_band_bounds

    tile, _, _, fits, live = tile_band_bounds(inputs[3], inputs[4], n, hf, band)
    tiles = int(tile.max()) + 1
    bad = torch.zeros(tiles, dtype=torch.int64, device=tile.device).index_add_(
        0, tile, (live & ~fits).to(torch.int64))
    has = torch.zeros_like(bad).index_add_(0, tile, live.to(torch.int64))
    return {"segments": int(live.sum()), "segments_fit": int(fits.sum()),
            "segment_share": float(fits.sum()) / max(1, int(live.sum())),
            "tiles": int((has > 0).sum()), "tile_share":
                float(((has > 0) & (bad == 0)).sum()) / max(1, int((has > 0).sum()))}


def band_routes(inputs, trunks, st, band: int, n: int, gen) -> dict:
    """K4's backward both ways on one forward's residuals and dy: the
    banded route's per-tile window counts against tile_band_bounds', every
    gradient of the two routes apart (the same terms in another order),
    and in bf16 each route's d(table) and the plain bf16 backward's against
    that backward summed in float64 (ROADMAP's d(table) watch).  The
    launches are not the main path's: their counters are restored."""
    import torch

    from alignsdf_torch.kernels.pixel_train_decoder import (
        pack_pixel_trunks, pixel_train_decode_backward, pixel_train_decode_backward_reference,
        pixel_train_decode_forward, tile_band_bounds)

    table, mean, xp, yp, mask, emb = inputs
    c, m = table.shape[2], emb.shape[0]
    bf16 = st.dtype == torch.bfloat16
    saved = (unbanded_bwd_counts(), band_counts(), pixel_train_decode_forward_counts())
    packed = pack_pixel_trunks(*inputs, trunks, st)
    y, acts, lat = pixel_train_decode_forward(packed, 5, st)
    dy = torch.randn(tuple(y.shape), generator=gen).to(y.device)
    fit = torch.full((-(-m // 64),), -1, dtype=torch.int32, device=y.device)
    banded = pixel_train_decode_backward(packed, st._replace(band=band), y, acts, lat, dy,
                                         tile_fit=fit)
    today = pixel_train_decode_backward(packed, st, y, acts, lat, dy)
    torch.cuda.synchronize()
    tile, _, _, fits, live = tile_band_bounds(yp, mask, n, st.feat_hw[0], band)
    want = torch.zeros_like(fit).index_add_(0, tile, fits.to(torch.int32))
    flat = lambda g: [*g[:5], *[t for layers in g[5] for group in zip(*layers)  # noqa: E731
                                for t in group if t is not None]]
    res = {"tile_fit_equal": bool(torch.equal(fit, want)), "windows": int(fit.sum()),
           "live_segments": int(live.sum()),
           "routes_max_rel_diff": max(float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
                                      for a, b in zip(flat(banded), flat(today)))}
    if bf16:
        unpadded = [[a[:b.shape[-1]].T.float() for a, b in zip(at, tr[3])]
                    for at, tr in zip(acts, trunks)]
        lat_u = lat[:c].T.float()
        with torch.no_grad():
            plain = pixel_train_decode_backward_reference(*inputs, trunks, st, y, unpadded,
                                                          lat_u, dy)[0]
            exact = pixel_train_decode_backward_reference(
                *(t.double() for t in (table, mean, xp, yp)), mask, emb.double(),
                [tuple(_f64(group) for group in tr) for tr in trunks], st, y.double(),
                [_f64(at) for at in unpadded], lat_u.double(), dy.double())[0]
        scale = float(exact.abs().max()) + 1e-30
        res["dtable_f64_rel_err"] = {
            who: float((t.double() - exact).abs().max()) / scale
            for who, t in (("banded", banded[0]), ("today's route", today[0]),
                           ("plain", plain))}
    (pixel_train_decode_backward.launches, pixel_train_decode_backward.bf16_launches) = saved[0]
    set_band_counts(saved[1])
    set_forward_counts(saved[2])
    return res


def pixel_train_decode_forward_counts() -> Tuple[int, int]:
    from alignsdf_torch.kernels.pixel_train_decoder import pixel_train_decode as f

    return f.launches, f.bf16_launches


def set_forward_counts(saved: Tuple[int, int]) -> None:
    from alignsdf_torch.kernels.pixel_train_decoder import pixel_train_decode as f

    f.launches, f.bf16_launches = saved


def tap_stage_bytes(inputs, packed) -> float:
    """The bytes K4's tap stage must move: the table entries of the cells
    the in-image points' taps touch, read once (2 bytes on a bf16 pack) and
    their d(table) written once, the latent's gradient (c_pad, M) read,
    xp, yp and the mask read, d(xp), d(yp) written, d(mean) written."""
    import torch

    table, mean, xp, yp, mask, emb = inputs
    b, hw, c = table.shape
    m = emb.shape[0]
    n = m // b
    hf = wf = int(round(hw ** 0.5))
    inside = mask > 0
    x0, y0 = torch.floor(xp).long(), torch.floor(yp).long()
    scene = torch.arange(m, device=xp.device) // n
    cells = []
    for i in range(4):
        for j in range(4):
            r, col = y0 + i - 1, x0 + j - 1
            ok = inside & (r >= 0) & (r < hf) & (col >= 0) & (col < wf)
            cells.append((scene * hw + r * wf + col)[ok])
    touched = int(torch.unique(torch.cat(cells)).numel())
    size = 2 if packed.dtype == torch.bfloat16 else 4
    return touched * c * (size + 4) + 4 * packed.c_pad * m + 4 * 5 * m + 4 * mean.numel()


def route_times(label: str, runs, card: str, chain_kernel: str) -> dict:
    """Each of ``runs`` ({route: backward}) timed in turns, forward and back
    (CUDA events, 5 calls a turn: the best turn), and its chain kernel by
    the profiler (CHAIN_PROFILED calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    order = list(runs) + list(reversed(runs))
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(cuda_ms(runs[k], 5))
    out = {}
    for k, bwd in runs.items():
        bwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CHAIN_PROFILED):
                bwd()
            torch.cuda.synchronize()
        chain = kernel_ms_per_launch(prof, chain_kernel)  # K4: one chain a call
        out[k] = {"bwd_ms": min(times[k]), "bwd_ms_runs": times[k], "chain_ms": chain}
        print(f"[{card}] {label}, {k}: backward {min(times[k]):.3f} ms (turns "
              + ", ".join(f"{t:.3f}" for t in times[k]) + "), chain "
              + ("not measured" if chain is None else f"{chain:.3f} ms") + " a step",
              flush=True)
    return out


def pixel_band_phase(dev, card: str, gen) -> Tuple[dict, list]:
    """Phase 23, K4's band and cli.train --pixel_band (see the module
    docstring).  Returns (record, the kernels line's entries: K4's banded
    backward in float32 and bf16)."""
    import numpy as np
    import torch

    from alignsdf_torch.cli import train as train_cli
    from alignsdf_torch.data.synthetic import write_synthetic_dataset
    from alignsdf_torch.kernels.pixel_train_decoder import (
        _lib, band_rows_max, pack_pixel_trunks, pixel_train_decode,
        pixel_train_decode_backward, pixel_train_decode_forward)
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.pixel_train_plan import default_band
    from alignsdf_torch.training.train_step import train_decoder_kind

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import pack_dataset_torch

    started = time.perf_counter()
    bf = lambda sp: dataclasses.replace(sp, compute_dtype="bfloat16")  # noqa: E731
    pix = flagship_specs(pixel=True)
    n = pix.samples_per_scene
    band = default_band(pix)
    rows = pix.image_size[0] // 4
    c = pix.latent_size
    rec = {"band": band, "check": {}, "routes": {}, "fits": {}, "timing": {}, "three_ways": {},
           "train": {}, "served": {}}
    limits = [_lib().pixel_train_band_rows_max(rows, -(-c // 256) * 256, flag) for flag in (0, 1)]
    print(f"--pixel_band's band: {band} rows of the {rows}-row map (the window's limit "
          f"{band_rows_max(rows, c)} in Python, {limits} in the library's float32 / bf16 build)",
          flush=True)
    if limits != [band_rows_max(rows, c)] * 2 or band != min(rows // 2, limits[0]):
        fail(f"the band's limit disagrees: {band_rows_max(rows, c)} against {limits}")

    for sp in (pix, bf(pix)):
        bf16 = sp.compute_dtype == "bfloat16"
        name = "K4 band bf16" if bf16 else "K4 band"
        model = build_model(sp, device=dev, seed=SEED)
        phase(f"{name} vs plain{' bf16' if bf16 else ''} ({TRAIN_SCENES} x {n} points, full "
              f"--pa_feat width, the HeadNet map and projection of a synthetic batch, each "
              f"scene's points sorted by the kernel's own yp, band {band})")
        inputs, trunks, st, _ = k4_operands(model, sp, dev, TRAIN_SCENES)
        inputs = row_sorted(inputs, TRAIN_SCENES)
        saved = band_counts()
        ck = k4_check(inputs, trunks, st._replace(band=band), dev, gen)
        set_band_counts(saved)
        rt = band_routes(inputs, trunks, st, band, n, gen)
        print(f"{name}: {rt['windows']} of {rt['live_segments']} live tile segments took the "
              f"window (the kernel's counts equal tile_band_bounds': {rt['tile_fit_equal']}); "
              f"the routes' gradients apart by {rt['routes_max_rel_diff']:.3e} of the largest",
              flush=True)
        if not (rt["tile_fit_equal"] and rt["windows"] == rt["live_segments"] > 0):
            fail(f"{name}: the sorted batch's tiles did not all take the window")
        if not rt["routes_max_rel_diff"] <= 1e-5:
            fail(f"{name}: the banded and the per-tap routes disagree")
        if bf16:
            k2_bf16_verdict(ck, "(sorted, 64 scenes)", name, BF16_RESID_SHARE_DEEP)
            print(f"{name} sampling gradients: {ck['sampling_grad_share_tight']:.6f} within "
                  f"{BF16_GRAD_RTOL:g} of the largest, max {ck['sampling_grad_max_rel_err']:.3e}"
                  f"; d(table) against the plain bf16 backward summed in float64: " + ", ".join(
                      f"{k} {v:.3e}" for k, v in rt["dtable_f64_rel_err"].items())
                  + " of the largest", flush=True)
            if not (ck["sampling_grad_share_tight"] >= BF16_SAMPLING_SHARE
                    and ck["sampling_grad_max_rel_err"] <= BF16_SAMPLING_GRAD_RTOL):
                fail(f"{name}'s sampling gradients disagree with the plain bf16 backward")
        else:
            print(f"{name} y max abs err {ck['y_max_abs_err']:.3e}; gradients max err "
                  f"{ck['grad_max_abs_err']:.3e} abs, {ck['grad_max_rel_err']:.3e} of the "
                  f"largest (tolerance {K4_TOL:g}); {forward_text(ck)}", flush=True)
            if not (ck["y_max_abs_err"] <= K4_TOL and ck["grad_max_rel_err"] <= K4_TOL):
                fail(f"{name} disagrees with its plain version")
            forward_verdict(ck, name, K4_TOL)
        rec["check"][name], rec["routes"][name] = ck, rt

        phase(f"timing: {name}'s backward three ways ({TRAIN_SCENES} x {n}): the unsorted "
              "batch and the host-sorted batch on the per-tap route, the host-sorted batch on "
              "the band's; the host-sorted batch's fits at the predicted root")
        plain_in, _, _, _ = k4_operands(model, sp, dev, TRAIN_SCENES)
        sorted_in, _, _, (fmap, uv) = k4_operands(model, sp, dev, TRAIN_SCENES, host_sort=True)
        rec["fits"][name] = fits = fit_share(sorted_in, n, rows, band)
        print(f"[{card}] {name}: the host-sorted batch at the predicted root: "
              f"{fits['segments_fit']} of {fits['segments']} live tile segments fit "
              f"({fits['segment_share']:.4f}), {fits['tile_share']:.4f} of {fits['tiles']} "
              f"tiles; the unsorted batch: {fit_share(plain_in, n, rows, band)['tile_share']:.4f}"
              " of its tiles", flush=True)
        runs, saved = {}, (unbanded_bwd_counts(), band_counts(),
                           pixel_train_decode_forward_counts())
        for key, ops, b in (("unsorted, per-tap route", plain_in, None),
                            ("host-sorted, per-tap route", sorted_in, None),
                            ("host-sorted, band", sorted_in, band)):
            packed = pack_pixel_trunks(*ops, trunks, st)
            y, acts, lat = pixel_train_decode_forward(packed, 5, st)
            dy = torch.randn(tuple(y.shape), generator=gen).to(dev)
            runs[key] = (lambda p=packed, y=y, a=acts, la=lat, d=dy, s=st._replace(band=b):
                         pixel_train_decode_backward(p, s, y, a, la, d))
        chain_kernel = (K4_BF16_BWD_KERNELS if bf16 else K4_BWD_KERNELS)[0]
        rec["three_ways"][name] = three = route_times(name, runs, card, chain_kernel)
        tap_bytes = tap_stage_bytes(sorted_in, pack_pixel_trunks(*sorted_in, trunks, st))
        del runs
        (pixel_train_decode_backward.launches,
         pixel_train_decode_backward.bf16_launches) = saved[0]
        set_band_counts(saved[1])
        set_forward_counts(saved[2])
        saved = band_counts()
        t = k4_timing(sorted_in, trunks, st._replace(band=band), fmap, uv, dev, gen, card)
        set_band_counts(saved)
        t["bwd"]["tap_stage_bytes"] = tap_bytes
        t["bwd"]["tap_stage_bytes_bound_ms"] = tap_bytes / HBM_BYTES_PER_S * 1e3
        if t["bwd"].get("chain") and three["host-sorted, band"]["chain_ms"] is not None:
            # the chain a launch, as the three ways read it (kernel_ms_per_launch)
            t["bwd"]["chain"]["ms"] = three["host-sorted, band"]["chain_ms"]
        rec["timing"][name] = t
        chain = t["bwd"].get("chain") or {}
        print(f"[{card}] {name}: the tap stage's bytes {tap_bytes / 1e9:.3f} GB, bound "
              f"{t['bwd']['tap_stage_bytes_bound_ms']:.3f} ms at 3.35 TB/s; the chain's FLOP "
              f"bound {chain.get('bound_ms', float('nan')):.3f} ms; chain kernel three ways "
              + ", ".join(f"{k} {v['chain_ms']}" for k, v in three.items()), flush=True)
        del model, inputs, plain_in, sorted_in, fmap, uv

    for key, sp in (("float32", pix), ("bf16", bf(pix))):
        bf16 = key == "bf16"
        for band_on in (True, False):
            label = f"--pa_feat{' --pixel_band' if band_on else ''} {key}"
            kern = (k4_band_kernel(bf16) if band_on else
                    (k4_bf16_kernel() if bf16 else k4_kernel()))
            phase(f"pixel band training: {label} through make_trainer, {WARM_STEPS} warm-up + "
                  f"{TIMED_STEPS} timed steps, {PROFILED_STEPS} profiled"
                  + ("; then cli.reconstruct" if band_on else ""))
            if band_on:
                kind = train_decoder_kind(train_cli.make_trainer(
                    sp, dev, seed=SEED, init_guard=False, pixel_band=True)[1].decode)
                print(f"train decoder: {kind}", flush=True)
                if f"band of {band} rows on host-sorted points" not in kind:
                    fail(f"--pixel_band's trainer runs {kind}")
            before = unbanded_bwd_counts()
            serve = ((lambda state, s=sp, lb=label, b=bf16: serve_cli(s, state, dev, card, lb,
                                                                      gen, b))
                     if band_on else None)
            r = bf16_train_run(sp, dev, card, label, kern, after=serve, pixel_band=band_on)
            if band_on and unbanded_bwd_counts() != before:
                fail(f"{label}: the per-tap backward launched")
            if band_on:
                rec["served"][label] = r.pop("after")
            rec["train"][label] = r
        b, u = (rec["train"][f"--pa_feat{f} {key}"] for f in (" --pixel_band", ""))
        busy = [r.get("profile", {}).get("per_step_ms", {}).get("busy") for r in (b, u)]
        idle = [r.get("profile", {}).get("idle_share") for r in (b, u)]
        print(f"[{card}] --pa_feat {key} train step with --pixel_band / without, in one call: "
              f"median {b['step_ms_median']:.2f} / {u['step_ms_median']:.2f} ms on the host "
              f"clock, device busy {busy[0]} / {busy[1]} ms a step, idle share {idle[0]} / "
              f"{idle[1]}", flush=True)

    phase(f"cli.train --packed --pa_feat --pixel_band: {PIXEL_BAND_PACK_SCENES} scenes packed, "
          f"{PIXEL_BAND_PACK_STEPS} steps")
    keys = [f"{i:08d}" for i in range(PIXEL_BAND_PACK_SCENES)]
    sorts = []
    real_sort = train_cli.pixel_row_sort_batch
    with tempfile.TemporaryDirectory() as tmp:
        pack = os.path.join(tmp, "train.pack")
        pack_dataset_torch.pack(write_synthetic_dataset(tmp, keys, image_hw=256), pack, keys,
                                "obman")
        split = os.path.join(tmp, "split.json")
        with open(split, "w") as f:
            json.dump({"train": keys * PIXEL_BAND_PACK_STEPS}, f)
        with open(os.path.join(REPO, "experiments", "obman_30k.json")) as f:
            raw = json.load(f)
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump(dict(raw, LMDB=False, ScenesPerBatch=PIXEL_BAND_PACK_SCENES,
                           TrainSplit=split, NumEpochs=1, LogFrequency=1, LogFrequencyStep=1,
                           SnapshotFrequency=0, AdditionalSnapshots=[]), f)
        counts = (pixel_train_decode.launches, unbanded_bwd_counts(), band_counts())
        train_cli.pixel_row_sort_batch = lambda *a, **k: sorts.append(1) or real_sort(*a, **k)
        try:
            t0 = time.perf_counter()
            train_cli.main(["-e", spec, "--mano", "--obj_pose", "--encode", "both",
                            "--point_size", "9", "--pa_feat", "--pixel_band", "--packed", pack,
                            "--device", dev.type, "--output_root", os.path.join(tmp, "out"),
                            "--skip_test"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            train_cli.pixel_row_sort_batch = real_sort
        exp = [os.path.join(root, "metrics.jsonl") for root, _, files in
               os.walk(os.path.join(tmp, "out")) if "metrics.jsonl" in files]
        with open(exp[0]) as f:
            steps = [ln for ln in map(json.loads, f) if "step" in ln]
    launched = (pixel_train_decode.launches - counts[0],
                band_counts()[0] - counts[2][0])
    rec["pack"] = {"wall_s": wall, "steps": len(steps), "sorted_batches": len(sorts),
                   "launches": {"fwd": launched[0], "bwd": launched[1]},
                   "totals": [s["total"] for s in steps]}
    print(f"[{card}] cli.train --packed --pixel_band: {len(steps)} steps in {wall:.2f} s "
          f"(writing and packing apart), {len(sorts)} native batches sorted in the loader's "
          f"workers, K4 launches fwd {launched[0]}, banded bwd {launched[1]}, per-tap bwd "
          f"{unbanded_bwd_counts()[0] - counts[1][0]}; losses "
          + ", ".join(f"{s['total']:.5f}" for s in steps), flush=True)
    if not (len(steps) == PIXEL_BAND_PACK_STEPS == launched[0] == launched[1] == len(sorts)
            and unbanded_bwd_counts() == counts[1]
            and all(np.isfinite(v) for s in steps for v in s.values())):
        fail("cli.train --packed --pixel_band did not train on sorted batches through the band")
    rec["seconds"] = time.perf_counter() - started
    print(f"phase 23 took {rec['seconds']:.1f} s", flush=True)

    entries = []
    for key, name in (("float32", "K4 band"), ("bf16", "K4 band bf16")):
        t = rec["timing"][name]["bwd"]
        by_path = {f"--pa_feat --pixel_band {key}":
                   rec["train"][f"--pa_feat --pixel_band {key}"]["launches"]["bwd"]}
        if key == "float32":
            by_path["cli.train --packed --pixel_band"] = rec["pack"]["launches"]["bwd"]
        entries.append({
            "name": f"{name} pixel train decoder, backward with the banded tap stage "
                    f"(band {band}, the host-sorted batch)",
            "route": "cuda", "source": "alignsdf_torch/kernels/csrc/pixel_train_decoder.cu",
            "replaces": "alignsdf_tpu/ops/decoder_train_pixel.py:647",
            "band_lines": "alignsdf_tpu/ops/decoder_train_pixel.py:605-632, :755-757",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": rec["check"][name]["grad_max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": f"F.grid_sample bicubic{' on bf16' if key == 'bf16' else ''}, "
                            "backward, at the sorted batch's points (the sampling step only)",
            "tap_stage_bytes_bound_ms": t["tap_stage_bytes_bound_ms"],
            "three_ways": rec["three_ways"][name], "fits": rec["fits"][name],
            **backward_entry(t),
        })
    return rec, entries


def fused_pass(kernel, plan, origin, voxel, chunk=1 << 20):
    """K1's or K3's (n_rows, n^3) output over a whole pass of ``plan`` in the
    fused evaluator's runs (``kernel`` the wrapper or its plain version)."""
    import torch

    total = plan.n ** 3
    with torch.no_grad():
        return torch.cat([kernel(plan, s, min(chunk, total - s), origin, voxel)
                          for s in range(0, total, chunk)], dim=1)


def main(record_path: Optional[str] = None) -> None:
    phase("device")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA GPU")
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from alignsdf_torch import use_float32_precision
        from alignsdf_torch.inference.grid import _coords_from_linear
        from alignsdf_torch.inference.reconstruct import (
            Reconstructor, make_output_dirs, run_pipelined)
        from alignsdf_torch.kernels import build
        from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference
        from alignsdf_torch.models.alignsdf import build_model
        from alignsdf_torch.ops.embeddings import kinematic_embedding
        from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
    except ImportError as e:
        fail(f"the port is not importable from {REPO}: {e}")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    use_float32_precision()
    dev = torch.device("cuda")
    record = {"card": card}

    phase("build")
    t0 = time.perf_counter()
    reports = build.build_all(["grid_decoder", "train_decoder", "pixel_grid_decoder",
                               "pixel_train_decoder", "generic_decoder", "generic_train_decoder",
                               "maxpool", "weight_grad"])
    record["build_s"] = time.perf_counter() - t0
    print(f"built in {record['build_s']:.2f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # the flagship config at full width
    specs = flagship_specs()
    model = build_model(specs, device=dev, seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    samples = synthetic_samples(gen, N_IMAGES)
    prepare = make_grid_decode_fn(specs, 64)
    shift_final_biases(model, specs, samples[0], dev)
    origin0 = torch.full((3,), -1.0, device=dev)
    voxel64 = torch.tensor(2.0 / 63, device=dev)

    phase("K1 vs plain (64^3, full flagship width, TF32 off)")
    plan64 = prepare(scene_ctx(model, specs, samples[0], dev)).plan
    before = grid_decode.launches
    k1 = grid_decode(plan64, 0, 64 ** 3, origin0, voxel64)
    torch.cuda.synchronize()
    ref = grid_decode_reference(plan64, 0, 64 ** 3, origin0, voxel64)
    max_err = float((k1 - ref).abs().max())
    grid_decode.launches = before  # comparison launches are not the main path's
    print(f"K1 max abs err vs plain: {max_err:.3e} (tolerance {K1_TOL:g}); "
          f"field range [{float(ref.min()):.4f}, {float(ref.max()):.4f}]", flush=True)
    if not (max_err <= K1_TOL):
        fail(f"K1 disagrees with its plain version: {max_err}")
    record["k1_max_abs_err"] = max_err

    record["k2_check"] = {}
    for scenes in CHECK_SCENES:
        phase(f"K2 vs plain ({scenes} x {specs.samples_per_scene} points, both trunks, "
              "full flagship width, TF32 off)")
        k2 = k2_check(model, specs, dev, gen, scenes)
        k2_verdict(k2, f"at {scenes} scenes")
        record["k2_check"][scenes] = k2
    # the kernels line reports the main path's shape
    k2 = record["k2_check"][TRAIN_SCENES]

    phase(f"main path: run_pipelined, {N_IMAGES} images at cube_dim {CUBE_DIM}")
    mano_faces = np.load(os.path.join(REPO, "alignsdf_torch", "assets", "closed_fmano.npy"))
    recon = Reconstructor(model, specs, cube_dim=CUBE_DIM, mano_faces=mano_faces)
    per_pass = -(-CUBE_DIM ** 3 // (1 << 20))  # the fused evaluator's runs are 2^20 points
    expected = N_IMAGES * 2 * per_pass
    results = []
    with tempfile.TemporaryDirectory() as out:
        dirs = make_output_dirs(out)
        grid_decode.launches = 0
        t0 = time.perf_counter()
        done = run_pipelined(recon, samples, dirs,
                             on_done=lambda i, p: results.append((i, p)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = grid_decode.launches
        written = sorted(os.listdir(dirs["meshes"]))
    print(f"images {done}, wall {wall * 1e3:.1f} ms, K1 launches {launches} "
          f"(expected {expected}), meshes written {written}", flush=True)
    if done != N_IMAGES or launches != expected:
        fail(f"K1 launches {launches} != expected {expected} over {done} images")
    if not written:
        fail("no mesh was written")
    record["main_path"] = {"wall_ms": wall * 1e3, "launches": launches, "meshes": written,
                           "images": []}
    for i, pending in results:
        host = pending["host"]
        for name in ("sdf_hand", "sdf_obj"):
            field = host[name]
            if tuple(field.shape) != (CUBE_DIM,) * 3 or not bool(torch.isfinite(field).all()):
                fail(f"image {i}: {name} has shape {tuple(field.shape)} or non-finite values")
        t = pending["timings"]
        inside = {n: float((host[n] < 0).float().mean()) for n in ("sdf_hand", "sdf_obj")}
        print(f"image {i} [{kind}]: encode {t['encode_ms']:.2f} ms, grid {t['grid_ms']:.2f} ms "
              f"(2 passes), {host_text(t)}, inside fraction {inside}, voxel "
              f"{float(host['voxel']):.5f}", flush=True)
        record["main_path"]["images"].append({**t, "inside": inside})

    # the field of image 0 against the generic decoder on materialized rows
    _, p0 = results[0]
    h0 = p0["host"]
    ctx = scene_ctx(model, specs, samples[0], dev)
    idx = torch.randint(0, CUBE_DIM ** 3, (4096,), generator=gen).to(dev)
    pts = _coords_from_linear(idx, CUBE_DIM, h0["origin"].to(dev), h0["voxel"].to(dev))
    emb = kinematic_embedding(pts, pts.shape[0], specs.point_feat_size, specs.sdf_scale_factor,
                              specs.encode_style, rot_center=ctx["rot_center"],
                              global_trans=ctx["global_trans"], obj_trans=ctx["obj_trans"])
    with torch.no_grad():
        gh, go, _ = model.decoder(torch.cat([ctx["latent"].expand(4096, -1), emb], dim=1))
    idx_cpu = idx.cpu()
    field_err = max(float((gh[:, 0].cpu() - h0["sdf_hand"].reshape(-1)[idx_cpu]).abs().max()),
                    float((go[:, 0].cpu() - h0["sdf_obj"].reshape(-1)[idx_cpu]).abs().max()))
    print(f"image 0 field vs generic decoder at 4096 grid points: max abs err {field_err:.3e}",
          flush=True)
    if not (field_err <= K1_TOL):
        fail(f"the main path's field disagrees with the generic decoder: {field_err}")
    record["field_vs_generic_max_abs_err"] = field_err

    phase("warm pipelined run, then the same run under torch.profiler")
    record["warm"], profiled = warm_and_profiled(recon, samples, grid_decode, card)
    if profiled is not None:
        record["profile"] = profiled
    del recon

    phase(f"training: {WARM_STEPS} warm-up + {TIMED_STEPS} timed steps at {TRAIN_SCENES} x "
          f"{specs.samples_per_scene} points, one step two ways, {PROFILED_STEPS} profiled steps")
    train_state, record["train"] = train_phase(specs, dev, card, k2_kernel())
    k2_launches = record["train"]["launches"]
    record["train_tf32_ms"] = tf32_step_ms(specs, train_state, dev, card)

    phase("timing: K1 and plain per grid pass")
    timing = {}
    for n, reps in ((CUBE_DIM, 3), (256, 1)):
        plan = make_grid_decode_fn(specs, n)(ctx).plan
        voxel = torch.tensor(2.0 / (n - 1), device=dev)
        chunk = min(1 << 20, n ** 3)

        def one_pass(fn):
            for start in range(0, n ** 3, chunk):
                fn(plan, start, min(chunk, n ** 3 - start), origin0, voxel)

        saved = grid_decode.launches
        k1_ms = cuda_ms(lambda: one_pass(grid_decode), reps)
        grid_decode.launches = saved
        plain_ms = cuda_ms(lambda: one_pass(grid_decode_reference), reps)
        flops = k1_flops_per_point(specs) * n ** 3
        out_bytes = 2 * 4 * n ** 3 + 4 * plan.flat.numel()
        timing[n] = {"k1_ms": k1_ms, "plain_ms": plain_ms, **grid_bounds(flops, out_bytes),
                     "tflop": flops / 1e12, "k1_tflops": flops / k1_ms / 1e9}
        print(f"[{card}] {n}^3 pass ({n ** 3} points, {flops / 1e12:.3f} TFLOP): "
              f"K1 {k1_ms:.2f} ms ({flops / k1_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
              f"{bounds_text(timing[n])}", flush=True)
    record["timing"] = timing
    image_flop = 2 * timing[CUBE_DIM]["tflop"]
    print(f"[{card}] K1 bounds for one image at {CUBE_DIM}^3 (two passes, {image_flop:.2f} "
          f"TFLOP): split TF32 "
          f"{SPLIT_TF32_PRODUCTS * image_flop * 1e12 / TF32_PEAK_FLOPS * 1e3:.1f} ms, float32 "
          f"{image_flop * 1e12 / FP32_PEAK_FLOPS * 1e3:.1f} ms", flush=True)

    phase(f"timing: K2 forward and backward per step ({TRAIN_SCENES} x "
          f"{specs.samples_per_scene} points, both trunks)")
    record["k2_timing"] = k2_timing(train_state.model, specs, dev, gen, card)
    del train_state

    record["pixel"], k3_entry = pixel_phase(dev, card, gen, mano_faces)
    record["pixel_train"], k4_entries = pixel_train_phase(dev, card, gen)
    record["classifier"], cls = classifier_phase(dev, card, gen, mano_faces)
    record["pixel_classifier"], pcls = classifier_phase(dev, card, gen, mano_faces, pixel=True)
    record["generic"], k6_entry = generic_phase(dev, card, gen, mano_faces)
    record["generic_train"], k5_entries = generic_train_phase(dev, card, gen)
    phase("K7 vs plain: the stem max pool at the train, serving and odd shapes")
    record["k7"] = k7_phase(dev, card)
    phase("serving with the stem pool through K7: image 0 of the flagship reconstruction")
    record["k7_serving"] = k7_serving_check(model, specs, samples[0], dev)
    record["dataset"] = dataset_phase(dev, card, record["train"])
    record["geometric"] = geometric_phase(dev, card)
    geo = record["geometric"]
    record["files"] = files_phase(dev, card)
    files = record["files"]
    record["pack"] = packed_phase(dev, card)
    pack = record["pack"]
    record["bf16"], bf16_entries = bf16_phase(dev, card, gen, mano_faces, model)
    record["bf16_train"], bf16_train_entries = bf16_train_phase(dev, card, gen, model, mano_faces)
    bt = record["bf16_train"]
    record["bf16_k4_k5"], bf16_k4k5_entries = bf16_pixel_generic_phase(dev, card, gen)
    b45 = record["bf16_k4_k5"]
    record["final_latent"], final_latent_entries = final_latent_phase(dev, card, gen, {
        "K2": record["k2_timing"], "K4": record["pixel_train"]["timing"],
        "K5": record["generic_train"]["timing"], "K2 bf16": bt["timing"],
        "K4 bf16": b45["k4_timing"], "K5 bf16": b45["k5_timing"]})
    record["pixel_band"], pixel_band_entries = pixel_band_phase(dev, card, gen)

    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)), exist_ok=True)
        with open(record_path, "w") as f:
            json.dump(record, f, indent=1, default=str)

    # each kernel ran on two main paths or more (K1: the flagship, the
    # classifier and the geometric proof; K2: those and dataset training; K3
    # and K4: --pa_feat and --pa_feat --cls); launches sum them, the times
    # are the first path's, the classifier's beside
    t = timing[CUBE_DIM]
    ct = cls["grid_timing"]
    kernels = {"kernels": [{
        "name": "K1 fused grid decoder, 2 + C rows (covers K1p)",
        "route": "cuda",
        "source": "alignsdf_torch/kernels/csrc/grid_decoder.cu",
        "trunk": TC_TRUNK_SOURCE,
        "replaces": "alignsdf_tpu/ops/decoder_kernel.py:496",
        "covers": "alignsdf_tpu/ops/decoder_kernel.py:381 (K1p, points-major, > 6 classes)",
        "launches": (launches + cls["grid_launches"] + geo["k1_launches"] + files["k1_launches"]
                     + sum(pack["k1_launches"].values())),
        "launches_by_path": {"flagship": launches, "classifier": cls["grid_launches"],
                             "geometric": geo["k1_launches"],
                             "per_file_test": files["k1_launches"],
                             **{f"{route} test": v for route, v in pack["k1_launches"].items()}},
        "max_abs_err": max(max_err, cls["grid_max_abs_err"], geo["k1_256_max_abs_err"]),
        "ms": t["k1_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "classifier_c6": {"ms": ct["ms"], "plain_ms": ct["plain_ms"],
                          "bound_ms": ct["bound_ms"], "bound_by": ct["bound_by"]},
        "trained_256_ms": geo["k1_256_ms"],
    }]}
    ck2 = cls["train_check"]
    for name, line, err, cerr, geo_key in (
            ("fwd", 472, k2["y_max_abs_err"], max(ck2["y_max_abs_err"], ck2["x_last_max_abs_err"]),
             "y_max_abs_err"),
            ("bwd", 652, k2["grad_max_abs_err"], ck2["grad_max_abs_err"], "grad_max_abs_err")):
        t2, c2 = record["k2_timing"][name], cls["train_timing"][name]
        kernels["kernels"].append({
            "name": f"K2 scene-factored train decoder, {'forward' if name == 'fwd' else 'backward'}",
            "route": "cuda",
            "source": "alignsdf_torch/kernels/csrc/train_decoder.cu",
            "replaces": f"alignsdf_tpu/ops/decoder_train_kernel.py:{line}",
            "launches": 0,  # the sum of launches_by_path, below
            "launches_by_path": {"flagship": k2_launches[name],
                                 "classifier": cls["train_launches"][name],
                                 "dataset_training": record["dataset"]["k2_launches"][name],
                                 "geometric": geo["k2_launches"][name],
                                 "per_file_training": files["k2_launches"][name],
                                 **{f"{route} training": v[name]
                                    for route, v in pack["k2_launches"].items()},
                                 "phase 20 flagship float32":
                                     bt["train"]["flagship float32"]["launches"][name],
                                 **{label: r["train"]["k2_launches"][name]
                                    for label, r in bt["configs"].items()
                                    if label.endswith("float32")}},
            "max_abs_err": max(err, cerr, geo["k2_check"][geo_key]),
            "ms": t2["ms"],
            "plain_ms": t2["plain_ms"],
            "bound_ms": t2["bound_ms"],
            "bound_by": t2["bound_by"],
            "library_ms": None,
            "classifier_x_last": {"ms": c2["ms"], "plain_ms": c2["plain_ms"],
                                  "bound_ms": c2["bound_ms"], "bound_by": c2["bound_by"]},
            **({"trunk": FWD_SOURCE} if name == "fwd" else backward_entry(t2)),
        })
    for e in kernels["kernels"][1:]:
        e["launches"] = sum(e["launches_by_path"].values())
    pt = pcls["grid_timing"]
    kernels["kernels"].append(dict(
        k3_entry, launches=k3_entry["launches"] + pcls["grid_launches"],
        launches_by_path={"pixel": k3_entry["launches"],
                          "pixel_classifier": pcls["grid_launches"]},
        max_abs_err=max(k3_entry["max_abs_err"], pcls["grid_max_abs_err"]),
        classifier_c6={"ms": pt["ms"], "plain_ms": pt["plain_ms"], "bound_ms": pt["bound_ms"],
                       "bound_by": pt["bound_by"]}))
    pk4 = pcls["train_check"]
    for entry, name, cerr in ((k4_entries[0], "fwd", max(pk4["y_max_abs_err"],
                                                          pk4["x_last_max_abs_err"])),
                              (k4_entries[1], "bwd", pk4["grad_max_abs_err"])):
        c4 = pcls["train_timing"][name]
        kernels["kernels"].append(dict(
            entry, launches=entry["launches"] + pcls["train_launches"][name],
            launches_by_path={"pixel": entry["launches"],
                              "pixel_classifier": pcls["train_launches"][name]},
            max_abs_err=max(entry["max_abs_err"], cerr),
            classifier_x_last={"ms": c4["ms"], "plain_ms": c4["plain_ms"],
                               "bound_ms": c4["bound_ms"], "bound_by": c4["bound_by"],
                               "library_ms": c4["library_ms"]}))
    kernels["kernels"] += [*k5_entries, k6_entry]
    # K7: the train shape's times; the serving batch's beside them
    for name, line in (("fwd", 122), ("bwd", 140)):
        t = record["k7"]["train"]["timing"][name]
        st = record["k7"]["serving"]["timing"][name]
        by_path = {"dataset_training": record["dataset"]["launches"][name],
                   "per_file_training": files["k7_launches"][name],
                   **{f"{route} training": v[name] for route, v in pack["k7_launches"].items()}}
        if name == "fwd":
            by_path["serving"] = record["k7_serving"]["launches"]
        err_key = "fwd_max_abs_err" if name == "fwd" else "grad_max_abs_err"
        kernels["kernels"].append({
            "name": f"K7 stem max pool 3x3/s2/p1, {'forward' if name == 'fwd' else 'backward'}",
            "route": "cuda",
            "source": "alignsdf_torch/kernels/csrc/maxpool.cu",
            "replaces": f"alignsdf_tpu/ops/maxpool.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(record["k7"][s][err_key] for s in K7_SHAPES),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": ("F.max_pool2d" if name == "fwd" else
                        "max_pool2d_with_indices_backward (a tied window's gradient to its "
                        "first maximum, not to every tie)"),
            "serving_batch_1": {k: st[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        })
    # the bf16 kernels: phase 19's main paths, K1's also BASELINE.json's
    # configs 1 and 2 and the trained flagship's --bf16 run (phase 16)
    cfg_launches = sum(r["launches"] for label, r in record["bf16"]["configs"].items()
                       if label.endswith("bf16"))
    for e in bf16_entries:
        if e["name"].startswith("K1"):
            by_path = {"flagship": e["launches"], "configs_1_2": cfg_launches,
                       "geometric": geo["bf16"]["launches"],
                       "geometric_bf16_trained": geo["bf16_trained"]["launches"],
                       **{f"{label} (phase 20, trained)": r["launches"]
                          for label, r in bt["configs"].items() if label.endswith("bf16")}}
            e.update(launches=sum(by_path.values()), launches_by_path=by_path,
                     max_abs_err=max(e["max_abs_err"], geo["k1_bf16_256"]["max_abs_err"]))
        kernels["kernels"].append(e)
    # phase 20's bf16 training kernels: K2 bf16 on the flagship's bf16
    # trainer, configs 1 and 2, the bf16-trained proof and the bf16 pack run;
    # K7 bf16 on the pack run (the stem pool switched to K7 there)
    for e in bf16_train_entries:
        name = "fwd" if e["name"].endswith("forward") else "bwd"
        if e["name"].startswith("K2"):
            by_path = {"flagship": bt["train"]["flagship bf16"]["launches"][name],
                       **{label: r["train"]["k2_launches"][name]
                          for label, r in bt["configs"].items() if label.endswith("bf16")},
                       "geometric": geo["bf16_trained"]["train"]["k2_launches"][name],
                       "pack training": pack["train_bf16"]["launches"]["k2"][name]}
        else:
            by_path = {"pack training": pack["train_bf16"]["launches"]["k7"][name]}
        e.update(launches=sum(by_path.values()), launches_by_path=by_path)
        kernels["kernels"].append(e)
    # phase 21's: K4 bf16 on the --pa_feat and --pa_feat --cls bf16 trainers,
    # K5 bf16 on latent_in (0, 2)'s
    for e in bf16_k4k5_entries:
        name = "fwd" if e["name"].endswith("forward") else "bwd"
        labels = ("--pa_feat", "--pa_feat --cls") if e["name"].startswith("K4") else (
            "latent_in (0, 2)",)
        by_path = {f"{label} bf16": b45["train"][f"{label} bf16"]["launches"][name]
                   for label in labels}
        e.update(launches=sum(by_path.values()), launches_by_path=by_path)
        kernels["kernels"].append(e)
    # phase 22's: K2, K4, K5 and K3 with a final-layer latent input, float32
    # and bf16, each launched by its variant's trainer (K3 by cli.reconstruct)
    kernels["kernels"] += final_latent_entries
    # phase 23's: K4's banded backward in float32 and bf16, launched by the
    # --pixel_band trainers and the --packed --pixel_band run
    kernels["kernels"] += pixel_band_entries
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, help="write the measurements as JSON here")
    main(parser.parse_args().record)
