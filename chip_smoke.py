#!/usr/bin/env python3
"""Drive the port's main paths on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py [--phases 3k,3l,4,5]

With no argument every phase runs (phases 1 and 2 always do; phases 4 and
5 cover the paths that ran). Phases (each fails loudly with a non-zero
exit):
  1. print the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build the five CUDA kernels and the JPEG entropy coder (host C) from
     lidarseg3d_torch/csrc into lidarseg3d_torch/build (one compiler per
     source, in parallel);
  3. semkitti: the SemanticKITTI MSeg3D inference forward (UNetSCN3D r=2,
     HRNet-w18 and the FCN head in fp32, fusion head; seeded random
     weights) on three distinct synthetic scans (V=131072, N=122880, one
     384x1280 camera, grid 21x256x256: rank tables only) through
     build_detector / forward / predict; check the outputs and that every
     kernel's launch count rose by its per-forward count on this path;
     compare a small model on the card with the same model on the CPU
     (plain versions); time scans and the branch split;
  3b. semnusc: the same for the nuScenes 6-camera forward (the JAX
     package's bench.py:155-175: HRNet-w18 and the FCN head in bf16,
     V=N=40960, six 640x960 cameras, 17 classes, 0.1 m grid 41x1024x1024
     whose stages 1-2 take KeyTables and the merge lookup, and whose point
     head devoxelizes on the sorted branch); also check the table kinds,
     the small card-vs-CPU agreement on that grid (fp32 image branch) and
     the bf16 image branch against an fp32 one with the same weights;
  3c. train: the MSeg3D training step at the semkitti shape (fp32, B=2,
     labels on, dropout 0.25) through apis.train.make_train_step: one warm
     step, then five counted steps on distinct batches; check that every
     loss term and the gradient norm are finite, that every parameter has
     a finite gradient and moved, that the BN running statistics moved,
     and that each step launched 36 forward + 35 dX rulebook convs (the
     input conv's features need no gradient), 36 dW kernels, 10 fused
     rulebook builds, one own-cell lookup and 4 packs (one per stage
     table, both samples in one launch); time the steps and
     the forward / backward / optimizer split. Then one train step of a
     small seeded model on the card (kernels) against the CPU (plain
     versions: loss terms within 1e-4; gradients of the lidar branch and
     the head within 1e-3 in relative L2 norm and 5e-3 of their max, of
     the image branch within 1e-2 and 2e-2, or else at least as close to
     the same step in float64 on the CPU as the CPU's fp32 gradient), each
     side's distance from the float64 step printed beside those limits, and
     twelve steps on one fixed small batch that must lower the loss;
  3d. eval: the published SemanticKITTI MSeg3D config
     (configs/semantickitti/MSeg3D/semkitti_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py:
     0.1 m grid 41x1504x1504, stages 1-2 on KeyTables, capacity 160000
     voxels / 131072 points, frozen_stages=3) at full width and depth,
     seeded weights with BN statistics calibrated on frame 0 (so labels
     spread), saved by save_checkpoint, evaluated by the entry point
     lidarseg3d_torch.tools.test (main, in-process, --speed_test) on a
     seeded tree of sequence 08 (8 frames of 120,000-125,000 points,
     1241x376 PNGs) through the val pipeline, the loader, run_eval and
     evaluation; check every frame's prediction against its label file's
     point count and the label range, that the predicted classes spread
     (printed), the mIoU (finite, above 0), the launches per scan of
     every kernel (semnusc's: the same table kinds), and that
     run_eval_device_hist's histogram equals the host histogram of the predictions; time the
     scans after the first and the host pipeline per frame; then frame 0
     at its published size through the same entry point on the CPU, and
     the mini config card against CPU (labels 99.9%, mIoU within 0.1
     point, each; these CPU-side runs, and every run of 3k-3m, take the
     loader's threads: an shm loader's start costs ~10-12 s);
  3e. train entry: the same published config trained at full width and
     depth through the entry point lidarseg3d_torch.tools.train (main,
     in-process; B=2 = samples_per_gpu, seeded weights; the config's
     pretrained HRNet-w18: a seeded state_dict in mmcv's names and shapes,
     torch.save'd and converted by the port's
     tools/convert_hrnet_checkpoint.py, imported bit for bit, its report
     in train.log) on a seeded tree of one frame
     in each of its ten train sequences (120,000-125,000 points, 1241x376
     PNGs) through the train pipeline (augmentations, colour jitter, JPEG
     round trip, label splat), the loader and train_segmentor:
     --total_epochs 2 --max_steps_per_epoch 2, which must write epoch_1,
     epoch_2 and latest.txt, then --resume_from --total_epochs 3, whose
     loaded state must equal the saved one exactly and which must start
     at global step 4; check every loss term and the gradient norm
     finite, every parameter outside the frozen stages moved, each step's
     launches of every kernel (those of phase 3d's tables keys, keys,
     rank, rank, plus 35 dX convs and 36 dW), the table kinds; print the
     step times (host clock to a synchronisation) and their p50 after the
     first, the loader's wait per step (the tools' default loader: shm
     workers on a host with more than two CPUs), the train pipeline's ms
     per frame by stage on one thread, the loader alone in thread mode
     and the peak memory;
  3f. eval-nu: the published nuScenes MSeg3D config
     (configs/semanticnusc/MSeg3D/semnusc_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py:
     0.1 m grid 41x1024x1024, capacity 40960 / 40960, six cameras,
     frozen_stages=3, with_cp, ACT_REMAT) at full width and depth as in
     3d, on a seeded val scene of three key frames
     (synthetic.write_semnusc_tree: 30,000-34,688 points, six 1600x900
     JPEGs each; infos and the --dry-data check by tools.create_data),
     through the entry point tools.test with the loader in shm mode; the
     checks of 3d (launches per scan (keys, keys, rank, rank), labels,
     spread, mIoU, the device histogram, frame 0 card vs CPU) but no mini
     config; also one JPEG read and its Huffman part;
  3g. train-nu: the same config trained as in 3e at its samples_per_gpu=3
     with with_cp and ACT_REMAT (87 forward + dX convs a step: 16 forward
     convs run again in the backward) and the loader in shm mode, on three
     seeded train scenes of two key frames: 1 epoch of 2 steps and a
     resume for a second; the checks and numbers of 3e (the loader's wait
     per step, not the loader alone);
  3h. sdseg-eval: the published SDSeg3D SemanticKITTI config
     (configs/semantickitti/SDSeg3D/semkitti_transVFE_unetscn3d_batchloss_e10.py:
     SegNet of TransVFE (three encoder layers), UNetSCN3D r=2 and the
     batch-loss head; grid 41x1504x1504, capacity 160000 / 131072) at
     full width as in 3d (BN calibrated on frame 0, tools.test with
     --speed_test) on a seeded 4-frame sequence 08, then its _tta config
     with --tta on a 3-frame one (four variant rows a frame, their softmax
     merged); the checks of 3d (launches per frame, labels, spread, mIoU,
     the device histogram without TTA, frame 0 card vs CPU with and without
     TTA), no mini config; 3h-3j take the loader's threads;
  3i. sdseg-train: the same config trained as in 3e at its
     samples_per_gpu=4 (the only B=4 path; TransVFE's layers recomputed in
     the backward), 1 epoch of 2 steps and a resume; per step 36 + 36 dX
     convs (TransVFE's output needs a gradient) and 36 dW;
  3j. sdseg-nu-tta: the published SDSeg3D nuScenes _tta config with --tta
     (six variant rows a frame; grid 41x1024x1024, capacity 40960) on a
     seeded val scene of three key frames, the checks of 3f without the
     JPEG read;
  3k. cyl-eval: the published Cylinder3D nuScenes config
     (configs/semanticnusc/Cylinder3D/semnusc_dymanicvfe_cylinder3d_lr1en2_e12.py:
     SegPolarNet of the dynamic cylindrical VFE, the asymmetric sparse
     UNet at init_size 16 on the 480x360x32 grid, 120,000 voxels, the
     PolarNet head; no host voxelization) through the entry point as 3j
     (BN calibrated on frame 0, a camera-less val scene of four key
     frames), then its _v2p config (the batch-loss head devoxelizing on
     the (32,360,480) KeyTable); launches per frame (merge 8 / 9: the
     point -> voxel lookup, 7 KeyTable rulebooks, the _v2p head), labels,
     spread, mIoU, the device histogram, frame 0 card vs CPU;
  3l. cyl-train: both configs trained through the entry point at
     samples_per_gpu=2, one epoch of 2 steps (Cylinder3D then a resume
     that must be bit for bit); per step every conv's dX and dW
  3m. polar: the published PolarNet nuScenes config (the dynamic BEV VFE,
     the circular BEV UNet on cuDNN: no kernel of the port, 0 launches)
     evaluated on four frames and trained at B=2, one epoch of 2 steps and
     a resume;
  3n. ddp: multi-process training and evaluation (parallel/), in spawned
     processes: (a) 3c's step at full width on two ranks sharing the card
     over gloo, one row of a labelled B=2 batch each (dropout on: every
     rank draws the global batch's mask), against one process on both
     rows: each rank's launches in the step are 3c's per step, the loss
     terms within 1e-4, the gradients (and the gradient norm) within
     TOL_DDP_GRAD, the parameters after the step within Adam's first
     update where the gradients settle its sign, the BN statistics within
     TOL_DDP_STATS, the
     ranks' states bit-identical after the first step and after three
     timed ones (each between two barriers: a step of two ranks sharing
     one card, not a scaling figure); (b) one NCCL rank started from
     torchrun's variables, deterministic algorithms on: its step on the
     B=2 batch bit for bit as the same step without a process group,
     where two runs without one agree bit for bit (elsewhere within four
     times their spread: the gathers' backward adds atomically); (c)
     tools.train at the published SemanticKITTI config on two ranks
     (--dist_* flags, --dist_share_card, B=2 a rank, 3e's tree and
     imported HRNet-w18, threads for the loader): one epoch of 2 steps
     writing epoch_1 once, then a resume for a second epoch; each step's
     launches are 3e's, every parameter outside the frozen stages moved,
     the resumed state equals epoch_1 on both ranks, and the final states
     are bit-identical; (d) tools.test on two ranks over three frames of
     3d's tree (BN calibrated): each rank's launches are two frames' of
     3d's, the ranks split the frames (rank 1's padding repeat of frame 0
     evaluated, not counted), the labels equal one rank's on every frame
     and the mIoU equals one rank's;
  3o. waymo-eval: the published SemanticWaymo MSeg3D config
     (configs/semanticwaymo/MSeg3D/semwaymo_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py:
     0.1 x 0.1 x 0.15 m grid 41x1504x1504, capacity 240000 voxels /
     196608 points, 23 classes, five cameras 1920x1280 / 1920x886 resized
     to 960x640, HRNet-w18 frozen_stages=3) at full width as in 3d (BN
     calibrated on frame 0, tools.test with --speed_test, the loader's
     threads)
     on three validation frames of a seeded tree
     (synthetic.write_semanticwaymo_tree, written once a run: ~186,700
     points and ~140,000 voxels a frame), then its lidar-only baseline
     (SegNet, the batch-loss head; threads); the checks of 3d (launches
     per frame (keys, keys, rank, rank), labels over the labelled TOP
     points, spread, mIoU, the device histogram, frame 0 card vs CPU);
     the host pipeline by stage and one 1920x1280 JPEG read;
  3p. waymo-train: both configs trained through tools.train at B=2
     (samples_per_gpu; MSeg3D from its imported pretrained HRNet-w18),
     on four training frames of the same tree: 1 epoch of 2 steps and a
     resume that must equal the checkpoint exactly; the checks and
     numbers of 3e, the peak memory (the loader's threads; 3e and 3g's
     resumes take threads too, their first runs the config's mode);
  3q. bf16 training and HRNet-w48: 3c's full-width step with the image
     branch in bf16 (HRNet and the FCN head compute_dtype="bfloat16",
     parameters, BN statistics and Adam in fp32; its launches, every
     parameter moved, and a step with every remat option on), a small
     seeded bf16 step card vs CPU within the bf16 limits of
     tests/test_torch_port_bf16_train.py (TOL_BF16_*; HRNet's BN on
     running statistics), and HRNet-w48 at one 640x960 image, forward and
     a training forward card vs CPU, its gradients at 384x256 against
     float64 (TF32 convolutions the control), a training step timed;
  3r. det-nu: the published nuScenes CenterPoint VoxelNet configs
     (configs/nusc/voxelnet/*: rotated, then circle NMS; 10 sweeps, grid
     41x1024x1024) through tools.test on a seeded tree with boxes and
     sweeps (BN calibrated on frame 0), the first trained through
     tools.train at B=4 (2 epochs of one step and a resume that must equal
     epoch_2); launches per frame and per step held, outputs checked (a
     valid box a frame), a mini cut card vs CPU (selections exact, boxes
     and scores within TOL_DET);
  3s. det-wy: the Waymo 3x config the same way (its db_sampler on the
     tree's gt database; B=4 = 4 x 150,000 conv rows), then the two-sweep
     velocity config through tools.test;
  3t. det-pp: the Waymo PointPillars config through both tools, which
     launches no kernel of the port (held at 0);
  3u. tsd: the published two-stage Waymo config
     (configs/waymo/voxelnet/two_stage/*_freeze.py: the 3x VoxelNet as a
     frozen first stage, 500 proposals a frame, the 5-point BEV extractor,
     the RoI head of 2560 inputs and (256, 256) layers, DP_RATIO=0.3)
     through tools.test on the det-wy tree's two val frames (BN calibrated
     on frame 0; launches a frame 21 / 0 / 4 / 4 / 2 as det-wy's; outputs,
     a mini cut card vs CPU) with a frame's first-stage forward,
     proposals, second stage and predict timed alone, then through
     tools.train at B=4 from a checkpoint whose first-stage head proposes
     fixed pedestrian boxes over a tree copy with a pedestrian at the
     origin of every train frame (so the RoI head's regression branch gets
     a gradient): launches a step as a frame's (no dX, dW or inverse
     rulebook under the frozen first stage), every first-stage parameter
     its decay-only update and its BN statistics bit for bit, a resume
     equal to epoch_2, the step times and the peak memory;
  3v. the tools (reads 3r's and 3s's outputs): tools.nusc_tracking on
     3r's detection JSON, the Waymo tracker (tools.waymo_tracking.track)
     on det-wy-velo's prediction pkl over the tree's moving vehicle poses
     (the metrics_pb2 writer needs waymo_open_dataset: not run),
     tools.simple_inference_waymo on a val frame through the 3x config
     (boxes against 3s's tools.test), tools.single_inference on a
     published-size scan through the SDSeg3D SemanticKITTI config (labels
     against tools.test's), and the C voxelizer against the numpy path
     byte for byte, each timed per frame at the published Waymo and
     SemanticKITTI sizes;
  3w. the last modules: UNetCylinder3D (r=2, 16 input features) on the
     480x360x32 cylindrical grid that the published Cylinder3D nuScenes
     config's VFE builds from a seeded 32-beam scan (capacity 120,000),
     bit for bit equal to UNetSCN3D with the same weights, its launches a
     forward and time; tools.warm_cache on the published SemanticKITTI
     MSeg3D config (a train and an eval step at B=2 on the synthetic
     batch of the config's shapes: the seconds and peak memory of each,
     the launches of 3e's step and 3d's frame); tools.synthetic_e2e, the
     train -> checkpoint -> eval -> TTA closure, cut to 6 frames and 12
     epochs at B=2 (the plain and TTA mIoU, held to 0.05, the JAX
     package's own closure at this cut less the spread of the port's
     initial draws, and to plain - 0.02; the seconds by stage; the
     launches of 36 3c steps and 12 frames); the full 40-frame closure at
     the tool's 0.85 is its own command (see the notes above phase 3w's
     code);
  4. hold each kernel against its plain version on the card at each main
     path's shapes, from a real scan of that path: the rulebook conv in
     fp32 and bf16 (stage-1 subm, stage-1->2 strided, stage-4 subm; and as
     dX under the transposed rulebook, up to the 256-wide output of the
     decoder's concat convs), the dW kernel in fp32 and bf16 (stage-1 subm
     12->32 and 32->32 at B=2, strided 32->64, stage-4 subm 256->128,
     inverse 128->128, and the semnusc stage-1 subm), the
     rank-table pack and lookup exactly (semkitti stage 1, semnusc stage
     3, and the pack of the train path's stage-1 table at B=2 in one
     call, read in place from the [B, NCE + 1] bitmap), the merge lookup
     exactly (semnusc stages 1 and 2, and stage 1's stream shuffled, which
     the kernel must answer in any order; each merge row prints the keys
     a search spans and the kernel's tiles by path: served wholly,
     partly or not at all from their shared-memory window), a CUDA graph
     of the pack replayed on changing bitmaps, and the pack, lookup
     and merge on the 92,865,984-cell 0.1 m SemanticKITTI structure
     (41x1504x1506); and, from a scan of the eval path (phase 3d), the
     conv at its stage-1 subm and stride-2 shapes, the merge on its
     stage-1 and stage-2 KeyTables, the pack and lookup on its stage-3
     RankTable; from a batch of the train entry path (phase 3e, B=2), the
     conv, dX and dW at its stage-1 shape and the merge on its stage-1 and
     stage-2 KeyTables; from a scan of eval-nu and a batch of train-nu
     (B=3), the merge on their stage-1 and stage-2 KeyTables, and at B=3
     the conv, dX and dW at the stage-1 shape; from a batch of sdseg-train
     (B=4), the input conv 16->32 forward and dX, dW 16->32 and 32->32,
     the merge on its stage-1 and stage-2 KeyTables and the pack of its
     stage-3 table (four rows in one launch), and the merge on the stage-1
     KeyTable of one TTA frame of 3h (4 rows) and 3j (6 rows); from a
     frame of cyl-eval and a B=2 batch of cyl-train (3k, 3l), all 24
     rulebooks of Cylinder3D's structures on both table kinds (K = 9 and
     3, the kernels one tap wide in x, strides (2,2,2) and (2,2,1)
     strided and inverse), the points' lookup through the merge kernel
     (queries in point order), the conv at K = 9 and 3, the 17-class
     classifier 64->17 and its dX 17->64 (fp32), the (2,2,1) strided and
     inverse convs, and the dW of those shapes at B=2; from a frame of
     waymo-eval (V=240000) and a B=2 batch of waymo-train (2 x 240000
     rows), the input conv 13->32, the stride-2 conv, the stage-1 dX and
     dW at B=2, every rulebook on both table kinds, the merge on the
     stage-1 and stage-2 KeyTables and the pack and lookup on the stage-3
     RankTable; from a frame of det-nu and a B=4 batch of det-wy-train,
     the detection shapes (check_det_paths: the (3,1,1) / (2,1,1) extra
     conv and its dX, stage 4's (0,1,1) conv, dX and dW at 600,000 rows,
     all 12 rulebooks of the chain on both table kinds); from 3w's
     paths' own inputs (the cylindrical grid's structure, warm_cache's
     B=2 batch, a frame of the closure's tree), the input and stride-2
     convs, the stage-1 dX and dW of the two training paths, every
     rulebook on both table kinds, the merge on the KeyTable stages and
     the pack and lookup on the first RankTable stage. The
     rulebook lookups: all
     10 rulebooks of each path's structures (semkitti, train at B=2,
     semnusc, eval, train entry at B=2, eval-nu, train-nu at B=3,
     sdseg-train at B=4), each
     exactly
     against its plain version and the path's own rulebook on both table
     kinds (the fused kernel on a RankTable; the front end, merge and
     decode on a KeyTable), timed on the path's own kind with the bytes
     bound, the wrapper's host time a call and torch.take of the in-grid
     cells as the partial yardstick of the gather alone (no one call
     builds a rulebook); the fused kernel on the 92.9M-cell table; an
     edge-heavy synthetic structure (B=2, ragged, every face of the grid
     active) with subm, strided and inverse rulebooks at padding 1 and
     (0, 1, 1) and the inverse with sx = 1 on both kinds; and the
     single-cell lookup at the semkitti and train heads' points (timed)
     and with queries outside every face; times are CUDA-event means of
     10 back-to-back calls
     after warm-up, device-only means (the profiler's summed kernel
     durations over 5 calls) and, for the pack and the merge, the wrapper's host time
     per call (back-to-back calls, no synchronisation); the pack row also
     times torch.cumsum of the bitmap and the merge row
     torch.searchsorted, partial yardsticks that give the rank field only;
  5. profile one scan of each inference path (the eval paths included;
     a TTA path's scan is one frame's variant rows) and one train step of
     each training path (device
     busy share and the kernels that take the time), and the
     structures+rulebooks part of one scan of semkitti, semnusc and eval
     (its device kernels and launches beside the count before the fused
     rulebook kernels, and the host operations that take its time);
     print the card line, one JSON line of the kernels, then the result
     line.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEV = "cuda"
NSCANS = 3
BIG_GRID = (41, 1504, 1504)  # the 0.1 m SemanticKITTI grid (Z, Y, X)
# H100 SXM published peaks (NVIDIA's data sheet, dense, at 700 W): HBM
# bytes/s and FLOP/s per input type. The conv kernels run fp32 on the tensor
# cores as 3xTF32 (three TF32 products per product, 495 TFLOP/s), the least
# time of an fp32-accurate product there; fp32 outside the tensor cores
# (67 TFLOP/s) is the second fp32 bound each conv row prints
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"fp32": 495e12 / 3, "bf16": 989e12}
PEAK_FP32_SIMT = 67e12
# kernel names of the conv and dW launches in a profile (phase 5)
CONV_KERNELS = ("conv_kernel", "conv_reduce", "dw_kernel", "dw_reduce")
TOL_CONV = {"fp32": 1e-5, "bf16": 2.0 ** -7}  # max |err| / max |plain|
# dW sums up to 262,144 products per entry in fp32 on both sides (the
# products of bf16 inputs are exact in fp32), in another order than the
# plain matmul
TOL_DW = {"fp32": 1e-5, "bf16": 1e-5}  # max |err| / max |plain|
# the training path (phase 3c): the semkitti shape at B=2 and the
# SemanticKITTI MSeg3D config's optimizer
TRAIN = dict(cfg=dict(ratio=2), B=2, V=131072, N=122880, img_hw=(384, 1280),
             steps=5,
             optimizer=dict(type="adam", wd=0.01),
             lr=dict(lr_max=0.01, moms=(0.95, 0.85), div_factor=10.0,
                     pct_start=0.4),
             total_steps=1000, grad_clip=35.0,
             # per step: 36 forward convs + 35 dX (every conv but the
             # input conv, whose features need no gradient); one dW per
             # conv; 10 rulebook builds on rank tables, one fused launch
             # each, + the head's own-cell lookup; one pack for each of the
             # four stages' rank tables (both samples in one launch)
             per_step={"rulebook_conv": 71, "rulebook_conv_dw": 36,
                       "rulebook_rank": 10, "rulebook_cells": 0,
                       "rulebook_decode": 0, "lookup_single": 1,
                       "rank_lookup": 0, "rank_pack": 4,
                       "merge_lookup": 0})
# phase 3n: multi-process training and evaluation (parallel/). (a) 3c's
# step on two ranks sharing the card over gloo, a row each, against one
# process on both rows (the two differ by the order of their sums and by
# cuDNN's algorithms for one image against two): the loss terms to
# TOL_TRAIN_LOSS, the gradients to TOL_DDP_GRAD, the BN statistics to
# TOL_DDP_STATS of their max, then timed steps;
# (c) tools.train at the published config on two ranks, an epoch of
# ``steps`` and a resume; (d) tools.test on two ranks over ``eval_frames``
# (odd) frames of 3d's tree
DDP = dict(seed=100, timed_steps=1, steps=2, eval_frames=3, timeout_s=900)
TOL_DDP_STATS = 1e-4
# (a)'s gradients (relative L2, max |err| / max). The ranks' step is one
# process's exactly in float64 (tests/test_torch_port_ddp_train.py: 1e-9,
# read 1e-13); in fp32 the two programs sum in other orders and run cuDNN
# at one image against two, and the image branch and the point head's
# eps=1e-6 camera BN carry that into the gradients: read 5.88e-3 (point
# head TorchLinear_1) and 3.31e-2 (HRNet's stem BN bias) in calls 3 and 4
# of PR 12, the same digits in both, where one process against itself
# reads 1.4e-6 and 1.2e-5 and each image alone against both at once, in
# evaluation mode, 1.7e-6 of the features' max; the image branch's
# smallest gradients (HRNet's deep stages, ~1e-4) read up to 5.1e-2 of
# their max entrywise (call 5)
TOL_DDP_GRAD = {"lidar+head": (1e-2, 2e-2), "image": (5e-2, 1e-1)}
# small train step, card against CPU: loss terms relative; each gradient
# tensor against the CPU's as (relative L2 norm, max |err| / max |CPU|),
# plus an absolute floor for tensors whose gradient is analytically zero.
# The lidar branch and the point head, whose gradients run through the
# port's kernels, are held to (1e-3, 5e-3); the entrywise limit is not
# 1e-3 because fp32 itself is noisier than that in front of the point
# head's eps=1e-6 BN (on the CPU the fp32 gradient of point_head
# TorchLinear_1.weight is 1.8e-3 of its max off a float64 run of the same
# step). The image branch (cuDNN against the CPU's convolutions, no kernel
# of the port; batch statistics over as few as 16 pixels) gets (1e-2, 2e-2).
# A tensor beyond a limit passes only where the float64 step arbitrates
# for the card: by that limit's measure (L2 norm, max entry) the card's
# gradient is at least as close to it as the CPU's fp32 one. Both fp32
# sides sit ~1e-3 from float64 in front of that BN, so two right answers
# can be 1e-3 apart: with the JAX package's initializers the camera
# projection point_head TorchLinear_1.weight read 1.075e-3 card vs CPU in
# L2, the card 8.43e-4 and the CPU 9.37e-4 from float64, the same under
# every cuDNN setting tried (deterministic, benchmark, channels-last, a
# zero workspace cap; cuDNN off: 1.103e-3, 5.81e-4 from float64;
# profile_train_precision.py). A kernel at fault is far from float64 too
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = {"lidar+head": (1e-3, 5e-3), "image": (1e-2, 2e-2)}
TOL_BF16_BRANCH = 0.1  # max |err| / max |fp32|, tests/_bf16_test_body.py
# phase 3d: the published SemanticKITTI MSeg3D config (0.1 m grid
# 41x1504x1504, capacity 160000 voxels / 131072 points, frozen_stages=3)
# evaluated through the entry point on a seeded tree of sequence 08, and
# the mini config card against CPU through the same entry point
EVAL = dict(config="configs/semantickitti/MSeg3D/"
            "semkitti_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py",
            frames=8, points=(120000, 125000), seed=0, image_hw=(376, 1241),
            max_range=75.0, mini="configs/tests/mini_semkitti_mseg3d.py",
            ncls=20)
# phase 3e: the published config trained through the entry point
# lidarseg3d_torch.tools.train at B=2 (samples_per_gpu) on a seeded tree
# of one frame in each of its ten train sequences, from its pretrained
# HRNet-w18 (a seeded mmcv state_dict converted by the port's converter):
# 2 epochs of 2 steps, then a resume for a third epoch. Per step on tables (keys, keys, rank,
# rank), read from the dispatch: phase 3d's rulebooks, merges and packs,
# 36 forward + 35 dX convs (the input conv's features need no gradient)
# and one dW per conv
TRAIN_ENTRY = dict(frames=1, points=(120000, 125000), seed=1,
                   pretrained_import=True,
                   image_hw=(376, 1241), max_range=75.0, epochs=2, steps=2,
                   per_step={"rulebook_conv": 71, "rulebook_conv_dw": 36,
                             "rulebook_rank": 5, "rulebook_cells": 5,
                             "rulebook_decode": 5, "lookup_single": 0,
                             "rank_lookup": 0, "rank_pack": 2,
                             "merge_lookup": 6})
# phase 3f: the published nuScenes-lidarseg MSeg3D config (0.1 m grid
# 41x1024x1024, capacity 40960 / 40960, six 1600x900 JPEG cameras resized
# to 960x640, frozen_stages=3, with_cp, ACT_REMAT) evaluated through the
# entry point on a seeded val scene (synthetic.write_semnusc_tree, infos
# from tools.create_data --cams); its tables are (keys, keys, rank, rank)
EVAL_NU = dict(config="configs/semanticnusc/MSeg3D/"
               "semnusc_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py",
               scenes=("scene-0003",), samples=3, points=(30000, 34688),
               seed=2, ncls=17)
# phase 3g: the same config trained through the entry point at its
# samples_per_gpu=3 with the loader in shm mode (the tools' default on a
# host with more than two CPUs) on three seeded train scenes of two key
# frames: 1 epoch of 2 steps, then a resume for a second. Per step as in
# phase 3e, plus the forward convs of the encoder's four residual stacks
# (2 blocks x 2 convs each) again in the backward under ACT_REMAT: 36 + 16
# forward + 35 dX convs
TRAIN_NU = dict(scenes=("scene-0001", "scene-0002", "scene-0041"),
                samples=2, points=(30000, 34688), seed=3, epochs=1, steps=2,
                per_step={**TRAIN_ENTRY["per_step"], "rulebook_conv": 87},
                loader_modes=())
# phases 3h-3j: SDSeg3D (SegNet: TransVFE of three layers, UNetSCN3D r=2,
# the batch-loss head) at its published configs. 3h: the SemanticKITTI
# config evaluated through the entry point on a seeded sequence 08, then
# its _tta config with --tta (each frame four variant rows); 3i: the same
# config trained at its samples_per_gpu=4, whose per-step launches are
# phase 3e's but 36 + 36 dX convs (TransVFE's output needs a gradient, so
# the input conv runs its dX too); 3j: the nuScenes _tta config with --tta
# (six variant rows a frame) on a seeded val scene. Tables (keys, keys,
# rank, rank) on every one. Their loaders run as threads: their
# pipelines read no camera, and an shm loader's start (~10 s) is phases
# 3d-3g's subject
SD_KITTI = "configs/semantickitti/SDSeg3D/semkitti_transVFE_unetscn3d_batchloss_e10"
EVAL_SD = dict(config=SD_KITTI + ".py", frames=4, points=(120000, 125000),
               seed=4, image_hw=(376, 1241), max_range=75.0, ncls=20,
               loader="thread")
EVAL_SD_TTA = dict(EVAL_SD, config=SD_KITTI + "_tta.py", frames=3, seed=5,
                   tta=True)
TRAIN_SD = dict(TRAIN_ENTRY, seed=6, epochs=1, steps=2, loader="thread",
                per_step={**TRAIN_ENTRY["per_step"], "rulebook_conv": 72})
EVAL_SD_NU = dict(config="configs/semanticnusc/SDSeg3D/"
                  "semnusc_transvfe_unetscn3d_batchloss_e48_tta.py",
                  scenes=("scene-0003",), samples=3, points=(30000, 34688),
                  seed=7, ncls=17, tta=True, cams=False, loader="thread")
# phases 3k-3m: the SegPolarNet family at its published nuScenes configs
# (no host voxelization: the readers voxelize on the card; camera-less
# trees). Launches per frame (B=1) and per step (B=2), read from the
# dispatch: the reader's point -> voxel lookup on the 480x360x32 grid's
# KeyTable is one merge; the backbone's five stage tables are (keys,
# rank, rank, rank, rank), one pack each RankTable; on s1 (KeyTable) the
# subm rulebooks (1,3,3), (3,1,3), (3,3,3), (3,1,1), (1,3,1), (1,1,3) and
# the strided rulebook into s2, a front end, a merge and a decode each; on
# the RankTables 17 fused rulebooks (s2-s4: (3,1,3), (1,3,3), (3,3,3),
# the strided one out and the inverse one in; s5: (3,3,3) and the inverse
# in); 48 convs (4 + 4 x 5 + 4 x 5 + 3 + the 17-class classifier), 47 in
# the _v2p variant, whose batch-loss head devoxelizes on the (32,360,480)
# KeyTable (one more merge). A train step adds a dX to every conv (the
# first convs read the reader's features) and one dW each. PolarNet (the
# BEV UNet) launches no kernel of the port
CYL_FRAME = {"rulebook_conv": 48, "rulebook_conv_dw": 0,
             "rulebook_rank": 17, "rulebook_cells": 7, "rulebook_decode": 7,
             "lookup_single": 0, "rank_lookup": 0, "rank_pack": 4,
             "merge_lookup": 8}
V2P_FRAME = {**CYL_FRAME, "rulebook_conv": 47, "merge_lookup": 9}
NO_KERNEL = {k: 0 for k in CYL_FRAME}
CYL = "configs/semanticnusc/Cylinder3D/semnusc_dymanicvfe_cylinder3d"
EVAL_CYL = dict(config=CYL + "_lr1en2_e12.py", scenes=("scene-0003",),
                samples=4, points=(30000, 34688), seed=8, ncls=17,
                cams=False, per_frame=CYL_FRAME, loader="thread",
                tables=("keys", "rank", "rank", "rank", "rank"))
EVAL_V2P = dict(EVAL_CYL, config=CYL + "_v2p_lr1en2_e12.py", seed=9,
                per_frame=V2P_FRAME)
TRAIN_CYL = dict(scenes=("scene-0001", "scene-0002"), samples=2,
                 points=(30000, 34688), seed=10, epochs=1, steps=2,
                 cams=False, loader_modes=(), tables=EVAL_CYL["tables"],
                 loader="thread",
                 per_step={**CYL_FRAME, "rulebook_conv": 96,
                           "rulebook_conv_dw": 48})
TRAIN_V2P = dict(TRAIN_CYL, seed=11, resume=False,
                 per_step={**V2P_FRAME, "rulebook_conv": 94,
                           "rulebook_conv_dw": 47})
POLAR = "configs/semanticnusc/PolarNet/semnusc_dymanicvfe_polarnet_lr1en2_e12.py"
EVAL_POLAR = dict(EVAL_CYL, config=POLAR, seed=12, per_frame=NO_KERNEL,
                  tables=None, cpu_frame=False)
TRAIN_POLAR = dict(TRAIN_CYL, seed=13, batch_size=2, tables=None,
                   per_step=NO_KERNEL)
# phases 3o-3p: the published SemanticWaymo configs (0.1 x 0.1 x 0.15 m
# grid 41x1504x1504, capacity 240000 voxels / 196608 points; MSeg3D with
# five cameras 1920x1280 / 1920x886 resized to 960x640, HRNet-w18
# frozen_stages=3, no remat; and its lidar-only SegNet baseline) on one
# seeded tree (synthetic.write_semanticwaymo_tree: ~186,700 points a
# frame, ~140,000 voxels) written once a run: three validation frames
# (3o) and four training frames (3p, B=2: an epoch of 2 steps and a
# resume). Launches per frame and per step, read from the dispatch: the
# tables are (keys, keys, rank, rank) as on the 0.1 m SemanticKITTI
# config; the baseline's ImprovedMeanVFE has no parameters, so its input
# conv runs no dX either (71 convs a step). The loader runs threads (the
# shm workers' start cost ~20 s a run; 3d-3g drive shm)
WAYMO = "configs/semanticwaymo/MSeg3D/semwaymo_avgvfe_unetscn3d_"
WAYMO_TREE = dict(frames={"training": 4, "validation": 3}, seed=14)
EVAL_WAYMO = dict(config=WAYMO + "hrnetw18_lr1en2_e12.py", waymo=True,
                  frames=3, ncls=23, loader="thread")
EVAL_WAYMO_BASE = dict(EVAL_WAYMO, config=WAYMO
                       + "lidarbaseline_lr1en2_e12.py", cams=False)
TRAIN_WAYMO = dict(waymo=True, epochs=1, steps=2, pretrained_import=True,
                   per_step=TRAIN_ENTRY["per_step"], loader_modes=(),
                   loader="thread")
TRAIN_WAYMO_BASE = dict(TRAIN_WAYMO, pretrained_import=False)
# phase 3q: 3c's step with the image branch in bf16 (HRNet and the FCN
# head compute_dtype="bfloat16"; parameters, BN statistics and Adam fp32)
# at full width, then a small seeded bf16 step on the card against the
# CPU within the limits of tests/test_torch_port_bf16_train.py (HRNet's BN
# on running statistics: at random weights batch statistics make its
# stage-4 gradient chaotic; relative L2 over each group's tensors
# together, set between the port-against-JAX reading and a zeroed
# group's 1.0); and HRNet-w48 at one 640x960 image, forward and a
# training step, card against CPU
TRAIN_BF16 = dict(TRAIN, cfg=dict(ratio=2, img_bf16=True), steps=2)
TOL_BF16_LOSS, TOL_BF16_GRAD_NORM = 1e-3, 1e-2
TOL_BF16_GRAD = {"lidar+head": 0.05, "image head": 0.25,
                 "image backbone": 0.4}
# w48 card vs CPU at 640x960: outputs max |err| / max |CPU| in evaluation
# and in training (batch statistics), and the running statistics. The
# gradients at W48_GRAD_HW against a float64 step on the CPU: the card's
# worst relative L2 over the tensors within TOL_W48_GRAD times the CPU
# fp32's own (plus 1e-4); fp32 order noise through ~200 BN layers of
# random weights puts either side within a few times the other (read at
# 384x256 on an H100: card 2.50e-2, CPU 1.46e-2). The control printed
# beside it, the card's step with TF32 convolutions (read 0.67), is what
# the limit must fail
TOL_W48_OUT = 1e-3
TOL_W48_GRAD = 3.0
W48_HW, W48_GRAD_HW = (640, 960), (256, 384)
# frames the host pipeline is timed on, one at a time (phases 3d-3j)
PIPELINE_FRAMES = 2
# card vs CPU through the entry point (phase 3's limits)
MIN_LABEL_AGREE, MAX_MIOU_POINTS = 0.999, 0.1
# phase 3d's labels must spread: classes predicted besides the ignore class
# 0, the share of points outside class 0, the largest share of one class
MIN_PRED_CLASSES, MIN_SHARE_NOT_0, MAX_SHARE_ONE_CLASS = 4, 0.05, 0.9
IMG_KEYS = ("image_features", "image_logits", "camera_semantic_embeddings")


# launches per scan on stage tables (keys, keys, rank, rank), read from the
# dispatch (sparse.build_rulebook): a KeyTable rulebook is the front end,
# one merge and the decode (t1: subm1 down2; t2: subm2 inv2 down3), a
# RankTable rulebook one fused launch (t3: subm3 inv3 down4; t4: subm4
# inv4); the sorted head is one more merge; one pack per RankTable
KEYS_KEYS_RANK_RANK = {"rulebook_conv": 36, "rulebook_conv_dw": 0,
                       "rulebook_rank": 5, "rulebook_cells": 5,
                       "rulebook_decode": 5, "lookup_single": 0,
                       "rank_lookup": 0, "rank_pack": 2, "merge_lookup": 6}


def main_paths():
    """The two main paths: model config, shapes, the table kind of each
    stage, and each kernel's launches per forward (read from the dispatch:
    10 rulebook builds + the point head)."""
    from lidarseg3d_torch import synthetic as syn

    nu = syn.SEMNUSC
    return {
        "semkitti": dict(
            cfg=dict(ratio=2), V=131072, N=122880, img_hw=(384, 1280),
            ncam=1, ncls=20, pcr=None, vsz=None, tables=("rank",) * 4,
            # 10 fused rulebook launches on rank tables; head: rulebook
            # reuse, one own-cell lookup
            per_forward={"rulebook_conv": 36, "rulebook_conv_dw": 0,
                         "rulebook_rank": 10, "rulebook_cells": 0,
                         "rulebook_decode": 0, "lookup_single": 1,
                         "rank_lookup": 0, "rank_pack": 4,
                         "merge_lookup": 0}),
        "semnusc": dict(
            cfg=dict(ratio=2, num_class=nu["num_class"], img_bf16=True,
                     pcr=nu["pcr"], vsz=nu["vsz"]),
            V=nu["V"], N=nu["N"], img_hw=nu["img_hw"], ncam=nu["ncam"],
            ncls=nu["num_class"], pcr=nu["pcr"], vsz=nu["vsz"],
            tables=("keys", "keys", "rank", "rank"),
            per_forward=KEYS_KEYS_RANK_RANK),
    }


def log(*a):
    print(*a, flush=True)


def wrappers():
    """The kernel wrappers by kernel name; each counts its launches."""
    from lidarseg3d_torch.ops import rank_lookup as rl
    from lidarseg3d_torch.ops.merge_lookup import merge_cells
    from lidarseg3d_torch.ops.rank_pack import pack_rank_table
    from lidarseg3d_torch.ops.rulebook_conv import (rulebook_conv,
                                                    rulebook_conv_dw)

    return {"rulebook_conv": rulebook_conv,
            "rulebook_conv_dw": rulebook_conv_dw,
            "rulebook_rank": rl.rulebook_rank,
            "rulebook_cells": rl.rulebook_cells,
            "rulebook_decode": rl.rulebook_decode,
            "lookup_single": rl.lookup_single, "rank_lookup": rl.gather_cells,
            "rank_pack": pack_rank_table, "merge_lookup": merge_cells}


def cuda_time(fn, reps=10, warmup=3):
    """Mean milliseconds of fn() over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_TRIES = 8


# the utility records prof.events() leaves out (torch.autograd.profiler
# _filter_name)
PROFILER_UTILITY = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
    "aten::_version"))


def activities(prof):
    """[(start us, end us, name, on the device)] of the activities a
    profiler session recorded, the events ``prof.events()`` gives, read
    from its raw kineto events: building the event tree took seconds for
    a train step's ~50,000 operations, more than the step's own
    profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if (start <= 0 or e.name() in PROFILER_UTILITY
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        out.append((start / 1e3, (start + e.duration_ns()) / 1e3, e.name(),
                    e.device_type() == DeviceType.CUDA))
    return out


def device_ms(fn, reps=5):
    """Mean device milliseconds per fn() call: the summed durations of the
    device activities fn starts (torch.profiler), without the host-side
    gaps between launches that ``cuda_time`` also counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a session now and then drops device events: all of them (2 to 6
    # sessions of the ~1000 in a run of this script on an H100, up to
    # three in a row) or some (0.57 against 0.92 ms for the same kernel).
    # Dropped events only lower the sum, so two sessions with events are
    # measured, up to PROFILE_TRIES tried, and the larger sum kept
    sums = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [(a, b) for a, b, _, dev in activities(prof) if dev]
        if kern:
            sums.append(sum(b - a for a, b in kern) / reps / 1e3)
            if len(sums) == 2:
                return max(sums)
        else:
            log(f"  profiler session {attempt + 1} recorded no device "
                "activity")
            time.sleep(0.2)
    raise SystemExit("profiler recorded device activity in fewer than 2 of "
                     f"{PROFILE_TRIES} sessions")


# calls timed of a kernel's plain version (its time is a reference, not a
# yardstick: the kernels are timed over 20)
PLAIN_REPS = 2


def timings(fn, plain, library=None, plain_reps=PLAIN_REPS):
    """The timing keys of a kernel row: CUDA-event means (``ms``,
    ``plain_ms``, ``library_ms``) and device-only means (``device_ms``,
    ``plain_device_ms``, ``library_device_ms``)."""
    t = dict(ms=cuda_time(fn),
             plain_ms=cuda_time(plain, reps=plain_reps, warmup=1),
             library_ms=None if library is None else cuda_time(library),
             device_ms=device_ms(fn),
             plain_device_ms=device_ms(plain, reps=plain_reps),
             library_device_ms=None)
    if library is not None:
        t["library_device_ms"] = device_ms(library)
    return t


def fmt_times(row):
    lib = ("" if row["library_ms"] is None else
           f" library_ms={row['library_ms']:.4f} "
           f"(device {row['library_device_ms']:.4f})")
    return (f"ms={row['ms']:.4f} (device {row['device_ms']:.4f}) "
            f"plain_ms={row['plain_ms']:.4f} (device "
            f"{row['plain_device_ms']:.4f}){lib}{fmt_bounds(row)}")


def bounds(dt, nbytes, flops):
    """The bound keys of a conv or dW row: ``bound_ms`` over the bytes and
    the operations at PEAK_FLOPS (3xTF32 for fp32), and for fp32 also the
    bound at 67 TFLOP/s outside the tensor cores."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dt]
    b = dict(bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    if dt == "fp32":
        t_simt = flops / PEAK_FP32_SIMT
        b.update(bound_fp32_simt_ms=max(t_bytes, t_simt) * 1e3,
                 bound_fp32_simt_by="bytes" if t_bytes >= t_simt
                 else "operations")
    return b


def fmt_bounds(row):
    s = f" bound_ms={row['bound_ms']:.4f} ({row['bound_by']}"
    if "bound_fp32_simt_ms" in row:
        s += (f", 3xTF32; at 67 TFLOP/s {row['bound_fp32_simt_ms']:.4f} "
              f"{row['bound_fp32_simt_by']}")
    return s + ")"


def check_conv(report, name, feats, rb, cin, cout, gen, dx=False,
               dtypes=("fp32", "bf16")):
    """rulebook_conv against rulebook_conv_plain in fp32 and bf16, twice
    (bit-identical reruns). feats [B, Vin, cin]. With ``dx`` the call is
    the data gradient's, as RulebookConvFn.backward makes it: feats is the
    cotangent (no zero row, miss = its row count), rb the transposed
    rulebook (a subm one is read with its taps mirrored), w read as
    [K, cout, cin] transposed, and a zero row appended to the output."""
    import torch
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.ops.rulebook_conv import (rulebook_conv,
                                                    rulebook_conv_plain)

    K = rb.shape[0]
    w32 = (torch.rand(K, cin, cout, generator=gen) * 2 - 1).to(DEV) \
        / (K * cin) ** 0.5
    miss = feats.shape[0] * feats.shape[1]
    flip = dx and rb.shape[2] == feats.shape[1]  # subm: its own transpose
    kw = dict(flip_taps=flip, w_t=True, miss=miss, zero_row=True) \
        if dx else {}
    hit = rb != miss
    pairs = int(hit.sum())
    # feature rows the function must read: the distinct partner rows, plus
    # the zero row of misses in the forward (capacity rows no entry names
    # are never read; dX reads no row for a miss)
    rows = int(torch.unique(rb[hit]).numel()) + (0 if dx else 1)
    M = rb.shape[1] * rb.shape[2]
    for dt in dtypes:
        torch_dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
        if dx:
            ff = feats.reshape(miss, cin).to(torch_dt).contiguous()
            w = w32.to(torch_dt).transpose(1, 2).contiguous()
        else:
            ff = sp.flat_features(feats.to(torch_dt))
            w = w32.to(torch_dt).contiguous()
        got = rulebook_conv(ff, rb, w, **kw)
        again = rulebook_conv(ff, rb, w, **kw)
        want = rulebook_conv_plain(ff, rb, w, **kw).float()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise SystemExit(f"rulebook_conv {name} {dt}: two runs on the "
                             "same inputs differ")
        got = got.float()
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        ok = err <= TOL_CONV[dt] * scale and got.shape == want.shape \
            and not (dx and got[-1].any())
        es = 4 if dt == "fp32" else 2
        nbytes = (rows * cin * es + rb.numel() * 4 + w.numel() * es
                  + (M + int(dx)) * cout * es)
        row = dict(
            name=f"rulebook_conv[{name} {cin}->{cout} {dt}]", route="cuda",
            source="lidarseg3d_torch/csrc/rulebook_conv.cu",
            replaces="lidarseg3d_tpu/ops/pallas_conv.py:215",
            launches=None, max_abs_err=err,
            **bounds(dt, nbytes, 2.0 * pairs * cin * cout),
            **timings(lambda: rulebook_conv(ff, rb, w, **kw),
                      lambda: rulebook_conv_plain(ff, rb, w, **kw),
))
        log(f"  conv {name} {cin}->{cout} {dt}: M={M} pairs={pairs} rows "
            f"read={rows} max_abs_err={err:.3e} (max|plain|={scale:.3e}, "
            f"tol {TOL_CONV[dt]:.1e} rel) bit-identical rerun"
            f"{', zero row zero' if dx else ''} {fmt_times(row)}")
        if not ok:
            raise SystemExit(f"rulebook_conv {name} {dt} disagrees with its "
                             f"plain version: {err} > {TOL_CONV[dt]}*{scale}")
        report.append(row)


def check_dw(report, name, feats, rb, cin, cout, gen,
             dtypes=("fp32", "bf16")):
    """rulebook_conv_dw against rulebook_conv_dw_plain in fp32 and bf16
    (``dtypes``): feats [B, Vin, cin] and a random cotangent [B*Vout,
    cout]."""
    import torch
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.ops.rulebook_conv import (rulebook_conv_dw,
                                                    rulebook_conv_dw_plain)

    K, M = rb.shape[0], rb.shape[1] * rb.shape[2]
    g32 = (torch.rand(M, cout, generator=gen) * 2 - 1).to(DEV)
    miss = feats.shape[0] * feats.shape[1]
    hit = rb != miss
    pairs = int(hit.sum())
    rows = int(torch.unique(rb[hit]).numel()) + 1
    # cotangent rows the function must read: those with a partner at some
    # tap (a row whose taps all miss adds nothing to any dW[k])
    grows = int(hit.any(0).sum())
    for dt in dtypes:
        torch_dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
        ff = sp.flat_features(feats.to(torch_dt))
        g = g32.to(torch_dt).contiguous()
        got = rulebook_conv_dw(ff, rb, g)
        again = rulebook_conv_dw(ff, rb, g)
        want = rulebook_conv_dw_plain(ff, rb, g)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or tuple(got.shape) != (K, cin, cout):
            raise SystemExit(f"rulebook_conv_dw {name} {dt}: output "
                             f"{got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, again):
            raise SystemExit(f"rulebook_conv_dw {name} {dt}: two runs on the "
                             "same inputs differ")
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        ok = err <= TOL_DW[dt] * scale
        es = 4 if dt == "fp32" else 2
        nbytes = (rows * cin * es + rb.numel() * 4 + grows * cout * es
                  + K * cin * cout * 4)
        row = dict(
            name=f"rulebook_conv_dw[{name} {cin}->{cout} {dt}]", route="cuda",
            source="lidarseg3d_torch/csrc/rulebook_conv_dw.cu",
            replaces="lidarseg3d_tpu/ops/pallas_conv.py:250",
            launches=None, max_abs_err=err,
            **bounds(dt, nbytes, 2.0 * pairs * cin * cout),
            **timings(lambda: rulebook_conv_dw(ff, rb, g),
                      lambda: rulebook_conv_dw_plain(ff, rb, g),
))
        log(f"  dW {name} {cin}->{cout} {dt}: M={M} pairs={pairs} rows read="
            f"{rows} gout rows read={grows} max_abs_err={err:.3e} "
            f"(max|plain|={scale:.3e}, tol {TOL_DW[dt]:.1e} rel) "
            f"bit-identical rerun {fmt_times(row)}")
        if not ok:
            raise SystemExit(f"rulebook_conv_dw {name} {dt} disagrees with "
                             f"its plain version: {err} > {TOL_DW[dt]}*{scale}")
        report.append(row)


def check_lookup(report, name, packed, cells):
    import torch
    from lidarseg3d_torch.ops.rank_lookup import (gather_cells,
                                                  gather_cells_plain)

    got = gather_cells(packed, cells)
    want = gather_cells_plain(packed, cells)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"rank_lookup {name} differs from its plain version "
                         f"at {int((got != want).sum())} queries")
    q = cells.numel()
    touched = int(torch.unique(cells).numel())
    flat = packed.reshape(-1)
    idx = cells.reshape(-1).to(torch.int64)  # B == 1: flat index == cell
    row = dict(
        name=f"rank_lookup[{name}]", route="cuda", source=RULEBOOK_SRC,
        replaces=lookup_replaces(packed.shape[1]),
        launches=None, max_abs_err=0.0,
        bound_ms=(8.0 * q + 4.0 * touched) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        **timings(lambda: gather_cells(packed, cells),
                lambda: gather_cells_plain(packed, cells),
                lambda: torch.take(flat, idx)))
    log(f"  lookup {name}: nce={packed.shape[1]} queries={q} exact "
        f"{fmt_times(row)}")
    report.append(row)


# UNetSCN3D.structures' rulebooks: the padding of the strided / inverse
# pair into and out of stage i (stage 4's z has none)
STAGE_PAD = {2: 1, 3: 1, 4: (0, 1, 1)}
# the edge structure of phase 4: every cell of the six faces of this grid
# active in sample 0, most of them in sample 1
EDGE_GRID = (20, 64, 80)
RULEBOOK_LIBRARY = "none (no one call builds a rulebook)"
RULEBOOK_SRC = "lidarseg3d_torch/csrc/rank_lookup.cu"


def lookup_replaces(nce):
    """The TPU kernel a lookup on a table of ``nce`` cells replaces: the
    VMEM-resident one up to the 12 MiB budget, else the HBM variant."""
    return ("lidarseg3d_tpu/ops/pallas_lookup.py:104" if nce * 4 > 12 * 2**20
            else "lidarseg3d_tpu/ops/pallas_lookup.py:69")


def path_rulebooks(books):
    """The 10 rulebooks of UNetSCN3D.structures: (name, the structure whose
    rows the rulebook fills, the stage whose table it reads, spec)."""
    from lidarseg3d_torch.ops import sparse as sp

    out = [(f"subm{i}", books[f"s{i}"], i,
            sp.subm_spec(books[f"t{i}"], books[f"s{i}"]))
           for i in range(1, 5)]
    for i in range(2, 5):
        lo, hi, p = books[f"s{i}"], books[f"s{i - 1}"], STAGE_PAD[i]
        out.append((f"down{i}", lo, i - 1,
                    sp.strided_spec(books[f"t{i - 1}"], hi, 3, 2, p)))
        out.append((f"inv{i}", hi, i,
                    sp.inverse_spec(books[f"t{i}"], lo, 3, 2, p)))
    return out


def path_taps(rb, spec):
    """The rulebook a path keeps of the kernels' [3G, B, V] output: all of
    it, or each group's middle tap for a kernel one tap wide in x."""
    if spec.kx == 3:
        return rb
    return rb.view(spec.groups, 3, *rb.shape[1:])[:, 1].contiguous()


def rulebook_rows(s):
    """Valid rows of structure ``s`` (their coordinates are read)."""
    return int(s.num_voxels.clamp(max=s.capacity).sum())


def exact(what, got, want):
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else "all"
        raise SystemExit(f"{what} differs from its reference at {bad} "
                         "entries")


def check_rulebook_rank(report, name, packed, s, spec, want=None):
    """rulebook_rank against rulebook_rank_plain, exactly, twice (and
    against ``want``, the path's own rulebook, if given); with a
    ``report`` list also the timed row. Returns the rulebook."""
    import torch
    from lidarseg3d_torch.ops import rank_lookup as rl

    c, n = s.coords, s.num_voxels

    def run():
        return rl.rulebook_rank(packed, c, n, spec)

    def plain():
        return rl.rulebook_rank_plain(packed, c, n, spec)

    got, ref = run(), plain()
    exact(f"rulebook_rank {name}", got, ref)
    exact(f"rulebook_rank {name} (rerun)", run(), ref)
    if want is not None:
        exact(f"rulebook_rank {name} against the path's rulebook",
              path_taps(got, spec), want)
    if report is None:
        return got
    cells, inb, _ = rl.rulebook_queries(c, n, spec)
    B, nce = packed.shape
    flat = (cells.long() + torch.arange(B, device=DEV).view(1, B, 1)
            * nce)[inb]
    sectors = int(torch.unique(flat >> 3).numel())
    nbytes = 12 * rulebook_rows(s) + 4 * B + 32 * sectors + 4 * got.numel()
    row = dict(name=f"rulebook_rank[{name}]", route="cuda",
               source=RULEBOOK_SRC, replaces=lookup_replaces(nce),
               launches=None, max_abs_err=0.0,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               library=RULEBOOK_LIBRARY,
               **timings(run, plain))
    row["host_ms"] = host_ms(run)
    take = lambda: torch.take(packed, flat)  # noqa: E731
    row["partial_take_ms"] = cuda_time(take)
    row["partial_take_device_ms"] = device_ms(take)
    log(f"  rulebook {name} on a RankTable: K={got.shape[0]} B={B} "
        f"V={got.shape[2]} nce={nce} in-grid queries={flat.numel()} sectors="
        f"{sectors} exact {fmt_times(row)} host_ms={row['host_ms']:.4f} "
        f"partial torch.take of the in-grid cells (gather only) "
        f"ms={row['partial_take_ms']:.4f} (device "
        f"{row['partial_take_device_ms']:.4f})")
    report.append(row)
    return got


def check_rulebook_keys(report, name, table, s, spec, want=None):
    """The KeyTable rulebook: rulebook_cells and rulebook_decode against
    their plain versions exactly, around merge_cells, and the three
    launches of sparse.build_rulebook equal to both (and to ``want``);
    with a ``report`` list also the timed rows of the front end and the
    decode, the decode's carrying the three launches' time. Returns the
    rulebook."""
    from lidarseg3d_torch.ops import rank_lookup as rl
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.ops.merge_lookup import merge_cells

    c, n = s.coords, s.num_voxels
    cells = rl.rulebook_cells(c, n, spec)
    exact(f"rulebook_cells {name}", cells, rl.rulebook_cells_plain(c, n,
                                                                   spec))
    values = merge_cells(table.keys, table.coarse, table.shift, table.num,
                         cells)
    got = rl.rulebook_decode(values, c, n, spec)
    exact(f"rulebook_decode {name}", got,
          rl.rulebook_decode_plain(values, c, n, spec))
    exact(f"KeyTable rulebook {name} (three launches)",
          sp.build_rulebook(table, s, spec), path_taps(got, spec))
    if want is not None:
        exact(f"KeyTable rulebook {name} against the path's rulebook",
              path_taps(got, spec), want)
    if report is None:
        return got
    _, inb, _ = rl.rulebook_queries(c, n, spec)
    B, V = c.shape[:2]
    for kern, fn, plain, nbytes in (
            ("rulebook_cells", lambda: rl.rulebook_cells(c, n, spec),
             lambda: rl.rulebook_cells_plain(c, n, spec),
             12 * B * V + 4 * B + 4 * cells.numel()),
            ("rulebook_decode", lambda: rl.rulebook_decode(values, c, n, spec),
             lambda: rl.rulebook_decode_plain(values, c, n, spec),
             12 * rulebook_rows(s) + 4 * B + 4 * int(inb.sum())
             + 4 * got.numel())):
        row = dict(name=f"{kern}[{name}]", route="cuda", source=RULEBOOK_SRC,
                   replaces="lidarseg3d_tpu/ops/pallas_lookup.py:69",
                   launches=None, max_abs_err=0.0,
                   bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                   library=RULEBOOK_LIBRARY,
                   **timings(fn, plain))
        row["host_ms"] = host_ms(fn)
        report.append(row)
        log(f"  {kern} {name}: exact {fmt_times(row)} host_ms="
            f"{row['host_ms']:.4f}")

    def build():
        return sp.build_rulebook(table, s, spec)

    row.update(build_ms=cuda_time(build), build_device_ms=device_ms(build),
               build_host_ms=host_ms(build))
    log(f"  rulebook {name} on a KeyTable (front end, merge, decode): K="
        f"{got.shape[0]} B={B} V={V} in-grid queries={int(inb.sum())} ms="
        f"{row['build_ms']:.4f} (device {row['build_device_ms']:.4f}) "
        f"host_ms={row['build_host_ms']:.4f}")
    return got


def check_path_rulebooks(report, path, books, rulebooks=None):
    """Every rulebook of a path's structures (``rulebooks``, by default
    UNetSCN3D's ten) through the fused kernel (a RankTable) or the front
    end, merge and decode (a KeyTable) against the plain versions and the
    path's own rulebook, timed on the path's table kind; and, untimed, on
    a table of the other kind of the same stage."""
    from lidarseg3d_torch.ops import coords as co

    rbs = path_rulebooks(books) if rulebooks is None else rulebooks
    other = {}
    for i in sorted({i for _, _, i, _ in rbs}):
        si = books[f"s{i}"]
        build = (co.build_rank_table if isinstance(books[f"t{i}"],
                                                   co.KeyTable)
                 else co.build_key_table)
        other[i] = build(si.coords, si.num_voxels, si.spatial_shape)
    for name, s, i, spec in rbs:
        label = f"{path} {name} B={s.batch_size} V={s.capacity}"
        table, want = books[f"t{i}"], books[name]
        if isinstance(table, co.KeyTable):
            check_rulebook_keys(report, label, table, s, spec, want)
            check_rulebook_rank(None, label, other[i].packed, s, spec, want)
        else:
            check_rulebook_rank(report, label, table.packed, s, spec, want)
            check_rulebook_keys(None, label, other[i], s, spec, want)
    log(f"  {path}: all {len(rbs)} rulebooks exact on both table kinds")


def check_single(report, name, packed, grid, q, ev):
    """lookup_single against lookup_single_plain, exactly; with a
    ``report`` list also the timed row."""
    import torch
    from lidarseg3d_torch.ops import rank_lookup as rl

    def run():
        return rl.lookup_single(packed, grid, q, ev)

    def plain():
        return rl.lookup_single_plain(packed, grid, q, ev)

    (r, f), (wr, wf) = run(), plain()
    exact(f"lookup_single {name} row", r, wr)
    exact(f"lookup_single {name} found", f, wf)
    if report is None:
        return
    B, nce = packed.shape
    Q = q.shape[1]
    flat = (rl.extended_cells(q, grid).clamp(0, nce - 1).long()
            + torch.arange(B, device=DEV).view(B, 1) * nce).reshape(-1)
    sectors = int(torch.unique(flat >> 3).numel())
    nbytes = B * Q * (12 + (0 if ev is None else 1) + 4 + 1) + 32 * sectors
    row = dict(name=f"lookup_single[{name}]", route="cuda",
               source=RULEBOOK_SRC, replaces=lookup_replaces(nce),
               launches=None, max_abs_err=0.0,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               **timings(run, plain,
                         lambda: torch.take(packed, flat)))
    row["host_ms"] = host_ms(run)
    log(f"  single-cell lookup {name}: B={B} Q={Q} nce={nce} found="
        f"{int(f.sum())} exact {fmt_times(row)} host_ms="
        f"{row['host_ms']:.4f} (library: torch.take of the cells)")
    report.append(row)


def check_edges(gen):
    """The fused kernel, the front end and the decode on an edge-heavy
    synthetic structure (B=2, ragged: all six faces of EDGE_GRID active in
    sample 0, most of their cells in sample 1): subm, strided and inverse
    rulebooks at padding 1 and (0, 1, 1) and the inverse with sx = 1, on
    both table kinds, against the plain versions and each other; and the
    single-cell lookup with queries far outside the grid."""
    import torch
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.ops import sparse as sp

    Z, Y, X = EDGE_GRID
    z, y, x = torch.meshgrid(torch.arange(Z), torch.arange(Y),
                             torch.arange(X), indexing="ij")
    face = ((z == 0) | (z == Z - 1) | (y == 0) | (y == Y - 1) | (x == 0)
            | (x == X - 1)).reshape(-1)
    r = [torch.rand(Z * Y * X, generator=gen) for _ in range(2)]
    keep = [face | (r[0] < 0.3), (face & (r[1] < 0.7)) | (r[1] < 0.05)]
    n = [int(k.sum()) for k in keep]
    cap = max(n) + 1000
    coords = torch.full((2, cap, 3), -1, dtype=torch.int32)
    for b, k in enumerate(keep):
        coords[b, :n[b]] = torch.stack([z.reshape(-1)[k], y.reshape(-1)[k],
                                        x.reshape(-1)[k]], -1).to(torch.int32)
    s1 = sp.build_structure(coords.to(DEV), torch.tensor(n, device=DEV),
                            EDGE_GRID)
    tables = lambda s: (  # noqa: E731
        co.build_rank_table(s.coords, s.num_voxels, s.spatial_shape),
        co.build_key_table(s.coords, s.num_voxels, s.spatial_shape))
    r1, k1 = tables(s1)
    cases = [("subm", s1, r1, k1, sp.subm_spec(r1, s1))]
    for stride, pad in ((2, 1), (2, (0, 1, 1)), ((2, 2, 1), 1)):
        s2 = sp.downsample_structure(s1, stride, capacity=cap // 2,
                                     padding=pad)
        r2, k2 = tables(s2)
        cases += [(f"strided {stride} pad {pad}", s2, r1, k1,
                   sp.strided_spec(r1, s1, 3, stride, pad)),
                  (f"inverse {stride} pad {pad}", s1, r2, k2,
                   sp.inverse_spec(r2, s2, 3, stride, pad))]
    for what, s, rt, kt, spec in cases:
        label = f"edge {what}"
        got = check_rulebook_rank(None, label, rt.packed, s, spec)
        check_rulebook_keys(None, label, kt, s, spec, want=got)
    q = torch.stack([torch.randint(-40, Z + 40, (2, 50000), generator=gen),
                     torch.randint(-4, Y + 4, (2, 50000), generator=gen),
                     torch.randint(-4, X + 4, (2, 50000), generator=gen)],
                    -1).to(torch.int32).to(DEV)
    ev = (torch.rand(2, 50000, generator=gen) < 0.9).to(DEV)
    for e in (None, ev):
        check_single(None, "edge", r1.packed, EDGE_GRID, q, e)
    log(f"  edge structure {EDGE_GRID} B=2 voxels {n} capacity {cap}: "
        f"{len(cases)} rulebooks exact on both table kinds (fused kernel; "
        "front end, merge, decode), single-cell lookup exact with queries "
        "outside every face")


def host_ms(fn, reps=50):
    """Mean host milliseconds per fn() call over back-to-back calls with no
    synchronisation: what the wrapper costs the host, launch included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def check_merge(report, name, table, cells, packed=None):
    """merge_lookup against merge_cells_plain, exactly (and, given the
    RankTable of the same voxels, against its gather on the same cells),
    with the keys each search spans (the block ranks' bracket of q+1's
    block) and the kernel's tiles by path (served wholly, partly or not at
    all from their shared-memory window; queries searched in device
    memory). For reference it also times torch.searchsorted(keys, cells,
    right=True): a partial yardstick that gives the rank field only."""
    import torch
    from lidarseg3d_torch.ops.merge_lookup import (PATHS, merge_cells,
                                                   merge_cells_plain)
    from lidarseg3d_torch.ops.rank_lookup import gather_cells_plain

    keys, num = table.keys, table.num
    counts = torch.zeros(len(PATHS), dtype=torch.int64, device=DEV)
    merge_cells(keys, table.coarse, table.shift, num, cells, paths=counts)
    paths = dict(zip(PATHS, counts.tolist()))

    def kern():
        return merge_cells(keys, table.coarse, table.shift, num, cells)

    got = kern()
    want = merge_cells_plain(keys, num, cells)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(kern(), want):
        raise SystemExit(f"merge_lookup {name} differs from its plain "
                         f"version at {int((got != want).sum())} queries")
    if packed is not None and not torch.equal(
            got, gather_cells_plain(packed, cells)):
        raise SystemExit(f"merge_lookup {name} differs from the rank-table "
                         "gather of the same voxels")
    j = ((cells.long() + 1) >> table.shift).clamp(
        0, table.coarse.shape[1] - 2).reshape(keys.shape[0], -1)
    span = (table.coarse.gather(1, j + 1) - table.coarse.gather(1, j)).float()
    search = dict(mean_keys=float(span.mean()), max_keys=int(span.max()))
    q = cells.numel()
    flatq = cells.reshape(keys.shape[0], -1)  # B == 1: one row of queries
    row = dict(
        name=f"merge_lookup[{name}]", route="cuda",
        source="lidarseg3d_torch/csrc/merge_lookup.cu",
        replaces="lidarseg3d_tpu/ops/pallas_merge.py:77",
        launches=None, max_abs_err=0.0,
        bound_ms=(8.0 * q + 4.0 * keys.numel() + 4.0 * num.numel())
        / PEAK_BYTES * 1e3,
        bound_by="bytes", search=search, paths=paths,
        **timings(kern, lambda: merge_cells_plain(keys, num, cells)))
    row["host_ms"] = host_ms(kern)
    partial = lambda: torch.searchsorted(keys, flatq, right=True)  # noqa
    row["partial_searchsorted_ms"] = cuda_time(partial)
    row["partial_searchsorted_device_ms"] = device_ms(partial)
    log(f"  merge {name}: keys={int(num.sum())}/{keys.shape[1]} queries={q} "
        f"exact{' (= rank gather)' if packed is not None else ''} "
        f"{fmt_times(row)} host_ms={row['host_ms']:.4f} partial "
        f"searchsorted (rank only) ms={row['partial_searchsorted_ms']:.4f} "
        f"(device {row['partial_searchsorted_device_ms']:.4f}); keys a "
        f"search spans: mean {search['mean_keys']:.1f}, max "
        f"{search['max_keys']}; tiles by path {paths}")
    report.append(row)


def check_pack(report, name, act, nce):
    """rank_pack against its plain version, exactly, on the first ``nce``
    cells of each row of act [B, NCE + 1] (read in place, as
    coords.build_rank_table does). For reference it also times
    torch.cumsum of the bitmap: a partial yardstick that gives the rank
    field only."""
    import torch
    from lidarseg3d_torch.ops.rank_pack import (pack_rank_table,
                                                pack_rank_table_plain)

    got = pack_rank_table(act, nce)
    want = pack_rank_table_plain(act, nce)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(
            pack_rank_table(act, nce), want):
        raise SystemExit(f"rank_pack {name} differs from its plain version "
                         f"at {int((got != want).sum())} cells")
    B = act.shape[0]
    row = dict(
        name=f"rank_pack[{name}]", route="cuda",
        source="lidarseg3d_torch/csrc/rank_pack.cu",
        replaces="lidarseg3d_tpu/ops/pallas_rank.py:48",
        launches=None, max_abs_err=0.0,
        bound_ms=5.0 * B * nce / PEAK_BYTES * 1e3, bound_by="bytes",
        **timings(lambda: pack_rank_table(act, nce),
                  lambda: pack_rank_table_plain(act, nce)))
    row["host_ms"] = host_ms(lambda: pack_rank_table(act, nce))
    a = act[:, :nce]
    partial = lambda: torch.cumsum(a, 1, dtype=torch.int32)  # noqa: E731
    row["partial_cumsum_ms"] = cuda_time(partial)
    row["partial_cumsum_device_ms"] = device_ms(partial)
    log(f"  pack {name}: B={B} nce={nce} active={int(a.sum())} exact "
        f"{fmt_times(row)} host_ms={row['host_ms']:.4f} partial cumsum "
        f"(rank only) ms={row['partial_cumsum_ms']:.4f} (device "
        f"{row['partial_cumsum_device_ms']:.4f})")
    report.append(row)


def check_pack_graph(act, nce):
    """The pack captured in a CUDA graph and replayed while the bitmap
    changes, with eager packs on the capture stream between replays: the
    kernel keeps its call state (tickets, epoch) on the device, so every
    result is exact. Then two packs across the wrap of the 30-bit epoch."""
    import torch
    from lidarseg3d_torch.ops.rank_pack import (pack_rank_table,
                                                pack_rank_table_plain)

    a = act.clone()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        pack_rank_table(a, nce)  # the stream's workspace, before capture
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out = pack_rank_table(a, nce)
    gen = torch.Generator(device=DEV).manual_seed(3)
    for r in range(4):
        a.copy_((torch.rand(a.shape, generator=gen, device=DEV)
                 < 0.05 * (r + 1)).to(torch.int8))
        g.replay()
        want = pack_rank_table_plain(a, nce)
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            eager = pack_rank_table(a, nce)
        torch.cuda.synchronize()
        if not torch.equal(out, want) or not torch.equal(eager, want):
            raise SystemExit(f"rank_pack replay {r} of a CUDA graph differs "
                             "from its plain version")
    # the epoch's wrap, which clears the status words: set the stream's
    # epoch to its last value, then two packs
    from lidarseg3d_torch.ops import rank_pack as rp

    ws = rp._workspaces[(a.device.index, s.cuda_stream)]
    ws[0] = rp.EPOCH_MASK << 32
    with torch.cuda.stream(s):
        wrapped = [pack_rank_table(act, nce) for _ in range(2)]
    torch.cuda.synchronize()
    exact = [torch.equal(w, pack_rank_table_plain(act, nce))
             for w in wrapped]
    if int(ws[0]) != 1 << 32 or int(ws[1]) != 0 or not all(exact):
        raise SystemExit(f"rank_pack across the epoch's wrap: workspace "
                         f"words {ws[:2].tolist()}, exact {exact}")
    log(f"  pack in a CUDA graph: 4 replays and 4 eager packs between them "
        f"on its stream, B={a.shape[0]} nce={nce}, exact; two packs across "
        "the epoch's wrap exact")


def subm_stream(books, i):
    """The query cells of stage ``i``'s subm rulebook, as the front end
    hands them to the merge kernel on a KeyTable (each query coordinate
    clamped into the grid)."""
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.ops.rank_lookup import rulebook_cells_plain

    s = books[f"s{i}"]
    return rulebook_cells_plain(s.coords, s.num_voxels,
                                sp.subm_spec(books[f"t{i}"], s))


def head_queries(run):
    """The point head's own-cell queries of a path's first example: the
    points' voxel coordinates and validity, as grid_three_interpolate
    hands them to coords.lookup_rank."""
    from lidarseg3d_torch.ops.interpolate import _point_voxel_coords

    head, ex = run["model"].point_head_mod, run["ex0"]
    return (_point_voxel_coords(ex["points"][..., :3], head.voxel_size,
                                head.point_cloud_range).contiguous(),
            ex["point_valid"].contiguous())


def kernel_checks(runs):
    """Phase 4: every kernel against its plain version at the main paths'
    shapes. Returns the report rows."""
    import torch
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.ops.rank_lookup import rulebook_cells_plain
    from lidarseg3d_torch.ops.rank_pack import pack_rank_table_plain

    report = []
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        if "semkitti" in runs:
            model, ex = runs["semkitti"]["model"], runs["semkitti"]["ex0"]
            st = model.lidar_input(ex)
            books = model.backbone_mod.structures(st.structure)
            s1, s4 = books["s1"], books["s4"]
            log(f"  semkitti stage voxels: s1={int(s1.num_voxels[0])}/"
                f"{s1.capacity} s2={int(books['s2'].num_voxels[0])} "
                f"s3={int(books['s3'].num_voxels[0])} "
                f"s4={int(s4.num_voxels[0])}/{s4.capacity}")

            # conv at its main-path shapes
            check_conv(report, "subm V=131072", st.features, books["subm1"], 12,
                       32, gen)
            f2 = torch.rand(1, s1.capacity, 32, generator=gen).to(DEV)
            check_conv(report, "strided 131072->65536", f2, books["down2"], 32,
                       64, gen)
            f4 = torch.rand(1, s4.capacity, 256, generator=gen).to(DEV)
            check_conv(report, f"subm V={s4.capacity}", f4, books["subm4"], 256,
                       128, gen)
            check_path_rulebooks(report, "semkitti", books)
            check_single(report, f"semkitti head N={ex['points'].shape[1]}",
                         books["t1"].packed, s1.spatial_shape,
                         *head_queries(runs["semkitti"]))

        if "train" in runs:
            # the training step's kernels at its own shapes (B=2): dW, and the
            # forward kernel as dX under the transposed rulebook (a subm
            # rulebook's transpose is its own with the taps mirrored; strided
            # and inverse rulebooks are each other's)
            tmodel, tex = runs["train"]["model"], runs["train"]["ex0"]
            tst = tmodel.lidar_input(tex)
            tb = tmodel.backbone_mod.structures(tst.structure)
            B, V1 = tst.features.shape[:2]
            c2, c3, c4 = (tb[f"s{i}"].capacity for i in (2, 3, 4))

            def rnd(v, c):
                return torch.rand(B, v, c, generator=gen).to(DEV)

            check_dw(report, f"subm B={B} V={V1}", tst.features, tb["subm1"], 12,
                     32, gen)
            check_dw(report, f"subm B={B} V={V1}", rnd(V1, 32), tb["subm1"], 32,
                     32, gen)
            check_dw(report, f"strided B={B} {V1}->{c2}", rnd(V1, 32),
                     tb["down2"], 32, 64, gen)
            check_dw(report, f"subm B={B} V={c4}", rnd(c4, 256), tb["subm4"],
                     256, 128, gen)
            check_dw(report, f"inverse B={B} {c4}->{c3}", rnd(c4, 128),
                     tb["inv4"], 128, 128, gen)
            check_conv(report, f"dX of subm 32->32 B={B} V={V1}", rnd(V1, 32),
                       tb["subm1"], 32, 32, gen, dx=True)
            check_conv(report, f"dX of strided 32->64 B={B} {c2}->{V1}",
                       rnd(c2, 64), tb["inv2"], 64, 32, gen, dx=True)
            check_conv(report, f"dX of subm 256->128 B={B} V={c4}", rnd(c4, 128),
                       tb["subm4"], 128, 256, gen, dx=True)
            check_path_rulebooks(report, "train", tb)
            tq, tv = head_queries(runs["train"])
            check_single(report, f"train head B={B} N={tq.shape[1]}",
                         tb["t1"].packed, tb["s1"].spatial_shape, tq, tv)
            # the train step's stage-1 table: both samples in one pack
            ts1 = tb["s1"]
            tact = co.activity(ts1.coords, ts1.num_voxels, ts1.spatial_shape)
            check_pack(report, f"train stage-1 B={B} {tact.shape[1] - 1} cells",
                       tact, tact.shape[1] - 1)
            del tb, tst, tact

        if "semkitti" in runs:
            # lookup + pack on the stage-1 table of this scan
            act1 = co.activity(s1.coords, s1.num_voxels, s1.spatial_shape)
            check_pack(report, "stage-1 1387008 cells", act1,
                       act1.shape[1] - 1)
            check_pack_graph(act1, act1.shape[1] - 1)
            check_lookup(report, "stage-1 1387008 cells", books["t1"].packed,
                         subm_stream(books, 1))

        if "semnusc" in runs:
            # semnusc: the conv, lookup and pack at their shapes on that path,
            # and the merge lookup on its KeyTable stages, from a real scan
            nmodel, nex = runs["semnusc"]["model"], runs["semnusc"]["ex0"]
            nst = nmodel.lidar_input(nex)
            nbooks = nmodel.backbone_mod.structures(nst.structure)
            ns1, ns4 = nbooks["s1"], nbooks["s4"]
            log(f"  semnusc stage voxels: " + " ".join(
                f"s{i}={int(nbooks[f's{i}'].num_voxels[0])}/"
                f"{nbooks[f's{i}'].capacity}" for i in range(1, 5)))
            check_conv(report, f"semnusc subm V={ns1.capacity}", nst.features,
                       nbooks["subm1"], 12, 32, gen)
            nf2 = torch.rand(1, ns1.capacity, 32, generator=gen).to(DEV)
            check_conv(report, f"semnusc strided {ns1.capacity}->"
                       f"{nbooks['s2'].capacity}", nf2, nbooks["down2"], 32, 64,
                       gen)
            nf4 = torch.rand(1, ns4.capacity, 256, generator=gen).to(DEV)
            check_conv(report, f"semnusc subm V={ns4.capacity}", nf4,
                       nbooks["subm4"], 256, 128, gen)
            check_dw(report, f"semnusc subm V={ns1.capacity}", nst.features,
                     nbooks["subm1"], 12, 32, gen)
            check_path_rulebooks(report, "semnusc", nbooks)
            s3 = nbooks["s3"]
            act3 = co.activity(s3.coords, s3.num_voxels, s3.spatial_shape)
            nce3 = act3.shape[1] - 1
            check_pack(report, f"semnusc stage-3 {nce3} cells", act3, nce3)
            check_lookup(report, f"semnusc stage-3 {nce3} cells",
                         nbooks["t3"].packed, subm_stream(nbooks, 3))
            for i in (1, 2):
                Z, Y, X = nbooks[f"s{i}"].spatial_shape
                check_merge(report, f"semnusc stage-{i} subm {Z * Y * (X + 2)} "
                            "cells", nbooks[f"t{i}"], subm_stream(nbooks, i))
            # stage 1's stream in another order: the kernel's contract is any
            # order, and a tile of shuffled queries spans the whole key set
            st1 = subm_stream(nbooks, 1)
            perm = torch.randperm(st1.shape[-1], generator=gen).to(DEV)
            Z, Y, X = ns1.spatial_shape
            check_merge(report, f"semnusc stage-1 subm shuffled "
                        f"{Z * Y * (X + 2)} cells", nbooks["t1"],
                        st1[..., perm].contiguous())
            del st1
            del nbooks, nst, nf2, nf4, act3

        if "eval" in runs:
            # the eval path (phase 3d): the published 0.1 m config's tables
            # and rulebooks from a real scan of the tree, stages 1-2 KeyTables
            emodel, eex = runs["eval"]["model"], runs["eval"]["ex0"]
            est = emodel.lidar_input(eex)
            eb = emodel.backbone_mod.structures(est.structure)
            ecap = eb["s1"].capacity
            log("  eval stage voxels: " + " ".join(
                f"s{i}={int(eb[f's{i}'].num_voxels[0])}/{eb[f's{i}'].capacity}"
                for i in range(1, 5)))
            check_conv(report, f"eval subm V={ecap}", est.features, eb["subm1"],
                       12, 32, gen)
            ef2 = torch.rand(1, ecap, 32, generator=gen).to(DEV)
            check_conv(report, f"eval strided {ecap}->{eb['s2'].capacity}", ef2,
                       eb["down2"], 32, 64, gen)
            check_path_rulebooks(report, "eval", eb)
            for i in (1, 2):
                Z, Y, X = eb[f"s{i}"].spatial_shape
                check_merge(report, f"eval stage-{i} subm {Z * Y * (X + 2)} "
                            "cells", eb[f"t{i}"], subm_stream(eb, i))
            es3 = eb["s3"]
            eact3 = co.activity(es3.coords, es3.num_voxels, es3.spatial_shape)
            ence3 = eact3.shape[1] - 1
            check_pack(report, f"eval stage-3 {ence3} cells", eact3, ence3)
            check_lookup(report, f"eval stage-3 {ence3} cells", eb["t3"].packed,
                         subm_stream(eb, 3))
            del eb, est, ef2, eact3

        if "train_entry" in runs:
            # the train entry path (phase 3e): the published config at B=2,
            # its conv, dX and dW at the stage-1 shape (2 x up to 160000 rows),
            # every rulebook on both table kinds and the merge on its stage-1
            # and stage-2 KeyTables
            xmodel, xex = runs["train_entry"]["model"], runs["train_entry"]["ex0"]
            xst = xmodel.lidar_input(xex)
            xb = xmodel.backbone_mod.structures(xst.structure)
            XB, XV = xst.features.shape[:2]
            log("  train entry stage voxels: " + " ".join(
                f"s{i}={xb[f's{i}'].num_voxels.tolist()}/{xb[f's{i}'].capacity}"
                for i in range(1, 5)))
            x32 = torch.rand(XB, XV, 32, generator=gen).to(DEV)
            check_conv(report, f"train01 subm B={XB} V={XV}", xst.features,
                       xb["subm1"], 12, 32, gen)
            check_conv(report, f"dX of subm 32->32 train01 B={XB} V={XV}", x32,
                       xb["subm1"], 32, 32, gen, dx=True)
            check_dw(report, f"train01 subm B={XB} V={XV}", xst.features,
                     xb["subm1"], 12, 32, gen)
            check_dw(report, f"train01 subm B={XB} V={XV}", x32, xb["subm1"], 32,
                     32, gen)
            check_path_rulebooks(report, "train01", xb)
            for i in (1, 2):
                Z, Y, X = xb[f"s{i}"].spatial_shape
                check_merge(report, f"train01 stage-{i} subm B={XB} "
                            f"{Z * Y * (X + 2)} cells", xb[f"t{i}"],
                            subm_stream(xb, i))
            del xb, xst, x32

        check_nusc_paths(report, runs, gen)
        check_waymo_paths(report, runs, gen)
        check_sdseg_paths(report, runs, gen)
        check_cyl_paths(report, runs, gen)
        check_det_paths(report, runs, gen)
        check_last_module_paths(report, runs, gen)

        # the 0.1 m SemanticKITTI grid: 41 x 1504 x (1504 + 2) cells, with
        # a semkitti scan's voxel count spread over it key-sorted
        V = 131072
        Z, Y, X = BIG_GRID
        nce = Z * Y * (X + 2)
        keys = torch.randperm(Z * Y * X, generator=gen)[:V].sort().values
        big = torch.stack([keys // (Y * X), (keys // X) % Y, keys % X],
                          -1).to(torch.int32)[None].to(DEV)
        nv = torch.tensor([V], dtype=torch.int32, device=DEV)
        actb = co.activity(big, nv, (Z, Y, X))
        check_pack(report, f"{nce} cells", actb, nce)
        sb = sp.build_structure(big, nv, (Z, Y, X))
        tb = co.RankTable(packed=pack_rank_table_plain(actb, nce),
                          spatial_shape=(Z, Y, X))
        del actb
        spec = sp.subm_spec(tb, sb)
        cells = rulebook_cells_plain(big, nv, spec)
        check_lookup(report, f"{nce} cells", tb.packed, cells)
        kt = co.build_key_table(big, nv, (Z, Y, X))
        check_merge(report, f"{nce} cells", kt, cells, packed=tb.packed)
        got = check_rulebook_rank(report, f"{nce}-cell subm V={V}", tb.packed,
                                  sb, spec)
        check_rulebook_keys(None, f"{nce}-cell subm V={V}", kt, sb, spec,
                            want=got)
        del tb, kt, cells, got
        check_edges(gen)
    torch.cuda.empty_cache()
    return report


def check_waymo_paths(report, runs, gen):
    """Phase 4's rows of the SemanticWaymo paths (phases 3o, 3p): from a
    real frame of waymo-eval (V=240000) and a real B=2 batch of waymo-train
    (2 x 240000 rows), the input conv 13->32 (fp32: 13 bf16 values are not
    a multiple of 4 bytes), the stride-2 conv 32->64, the stage-1 dX
    32->32 and the dW 32->32 at B=2, every rulebook on both table kinds,
    the merge on the stage-1 and stage-2 KeyTables, and the pack and the
    fused lookup on the stage-3 RankTable."""
    import torch
    from lidarseg3d_torch.ops import coords as co

    for name in ("waymo_eval", "waymo_train"):
        if name not in runs:
            continue
        m, ex = runs[name]["model"], runs[name]["ex0"]
        with torch.no_grad():
            st = m.lidar_input(ex)
        b = m.backbone_mod.structures(st.structure)
        B, V = st.features.shape[:2]
        cin = st.features.shape[-1]
        log(f"  {name} stage voxels: " + " ".join(
            f"s{i}={b[f's{i}'].num_voxels.tolist()}/{b[f's{i}'].capacity}"
            for i in range(1, 5)))
        check_conv(report, f"{name} subm {cin}->32 B={B} V={V}",
                   st.features.detach(), b["subm1"], cin, 32, gen,
                   dtypes=("fp32",))
        f32 = torch.rand(B, V, 32, generator=gen).to(DEV)
        check_conv(report, f"{name} strided 32->64 B={B} {V}->"
                   f"{b['s2'].capacity}", f32, b["down2"], 32, 64, gen)
        if name == "waymo_train":
            check_conv(report, f"dX of subm 32->32 {name} B={B} V={V}",
                       f32, b["subm1"], 32, 32, gen, dx=True)
            check_dw(report, f"{name} subm B={B} V={V}", f32, b["subm1"],
                     32, 32, gen)
        del f32
        check_path_rulebooks(report, name, b)
        for i in (1, 2):
            Z, Y, X = b[f"s{i}"].spatial_shape
            check_merge(report, f"{name} stage-{i} subm B={B} "
                        f"{Z * Y * (X + 2)} cells", b[f"t{i}"],
                        subm_stream(b, i))
        s3 = b["s3"]
        act3 = co.activity(s3.coords, s3.num_voxels, s3.spatial_shape)
        nce3 = act3.shape[1] - 1
        check_pack(report, f"{name} stage-3 B={B} {nce3} cells", act3, nce3)
        check_lookup(report, f"{name} stage-3 B={B} {nce3} cells",
                     b["t3"].packed, subm_stream(b, 3))
        del b, st, act3


def check_nusc_paths(report, runs, gen):
    """Phase 4's rows of the nuScenes paths (phases 3f, 3g): every
    rulebook of a real scan and of a real B=3 batch on both table kinds,
    the merge on their stage-1 and stage-2 KeyTables; at B=3 also the
    conv, dX and dW at the stage-1 shape (3 x 40960 rows)."""
    import torch

    for name in ("eval_nu", "train_nu"):
        if name not in runs:
            continue
        ymodel, yex = runs[name]["model"], runs[name]["ex0"]
        yst = ymodel.lidar_input(yex)
        yb = ymodel.backbone_mod.structures(yst.structure)
        YB, YV = yst.features.shape[:2]
        log(f"  {name} stage voxels: " + " ".join(
            f"s{i}={yb[f's{i}'].num_voxels.tolist()}/"
            f"{yb[f's{i}'].capacity}" for i in range(1, 5)))
        if name == "train_nu":
            # the input conv's 13 channels (5 point + 8 encoded
            # features) run in fp32 only: 13 bf16 values are not a
            # multiple of 4 bytes
            cin = yst.features.shape[-1]
            y32 = torch.rand(YB, YV, 32, generator=gen).to(DEV)
            check_conv(report, f"{name} subm B={YB} V={YV}",
                       yst.features, yb["subm1"], cin, 32, gen,
                       dtypes=("fp32",))
            check_conv(report, f"dX of subm 32->32 {name} B={YB} "
                       f"V={YV}", y32, yb["subm1"], 32, 32, gen, dx=True)
            check_dw(report, f"{name} subm B={YB} V={YV}", y32,
                     yb["subm1"], 32, 32, gen)
            del y32
        check_path_rulebooks(report, name, yb)
        for i in (1, 2):
            Z, Y, X = yb[f"s{i}"].spatial_shape
            check_merge(report, f"{name} stage-{i} subm B={YB} "
                        f"{Z * Y * (X + 2)} cells", yb[f"t{i}"],
                        subm_stream(yb, i))
        del yb, yst


def check_sdseg_paths(report, runs, gen):
    """Phase 4's rows of the SDSeg3D paths (phases 3h-3j): from a real
    B=4 batch of sdseg-train, the input conv 16->32 (TransVFE's features)
    forward and as dX, the dW of it and of the stage-1 32->32 conv, every
    rulebook on both table kinds, the merge on its stage-1 and stage-2
    KeyTables and the pack of its stage-3 RankTable (four rows in one
    launch); from one TTA frame of sdseg-eval (4 rows) and sdseg-nu (6
    rows), the merge on the stage-1 KeyTable."""
    import torch
    from lidarseg3d_torch.ops import coords as co

    for name in ("sd_eval_tta", "sd_nu_tta"):
        if name not in runs:
            continue
        m, x = runs[name]["model"], runs[name]["ex0"]
        with torch.inference_mode():
            b = m.backbone_mod.structures(m.lidar_input(x).structure)
            Z, Y, X = b["s1"].spatial_shape
            check_merge(report, f"{name} stage-1 subm B={b['s1'].batch_size}"
                        f" (TTA rows) {Z * Y * (X + 2)} cells", b["t1"],
                        subm_stream(b, 1))
        del b
    if "sd_train" not in runs:
        return
    model, ex = runs["sd_train"]["model"], runs["sd_train"]["ex0"]
    with torch.no_grad():
        st = model.lidar_input(ex)
    books = model.backbone_mod.structures(st.structure)
    B, V = st.features.shape[:2]
    log("  sd_train stage voxels: " + " ".join(
        f"s{i}={books[f's{i}'].num_voxels.tolist()}/"
        f"{books[f's{i}'].capacity}" for i in range(1, 5)))
    g32 = torch.rand(B, V, 32, generator=gen).to(DEV)
    check_conv(report, f"sdseg subm B={B} V={V}", st.features,
               books["subm1"], 16, 32, gen)
    check_conv(report, f"dX of subm 16->32 sdseg B={B} V={V}", g32,
               books["subm1"], 32, 16, gen, dx=True)
    check_dw(report, f"sdseg subm B={B} V={V}", st.features, books["subm1"],
             16, 32, gen)
    check_dw(report, f"sdseg subm B={B} V={V}", g32, books["subm1"], 32, 32,
             gen)
    del g32
    check_path_rulebooks(report, "sd_train", books)
    for i in (1, 2):
        Z, Y, X = books[f"s{i}"].spatial_shape
        check_merge(report, f"sd_train stage-{i} subm B={B} "
                    f"{Z * Y * (X + 2)} cells", books[f"t{i}"],
                    subm_stream(books, i))
    s3 = books["s3"]
    act3 = co.activity(s3.coords, s3.num_voxels, s3.spatial_shape)
    nce3 = act3.shape[1] - 1
    check_pack(report, f"sd_train stage-3 B={B} {nce3} cells", act3, nce3)
    del books, st, act3


def cyl_rulebooks(books):
    """The 24 rulebooks of Cylinder3D_Asymm_3d_spconv.structures: (name,
    the structure whose rows it fills, the stage whose table it reads,
    spec, the path's rulebook)."""
    from lidarseg3d_torch.ops import sparse as sp

    ss = [books[f"s{i}"] for i in range(1, 6)]
    ts = [books[f"t{i}"] for i in range(1, 6)]
    out = []
    for key, rb in books.items():
        if not isinstance(key, tuple):
            continue
        a, b = key
        i = next(j for j, s in enumerate(ss) if id(s) == a)
        if isinstance(b, tuple):  # a subm rulebook of kernel b
            out.append((f"subm{i + 1} {b}", ss[i], i + 1,
                        sp.subm_spec(ts[i], ss[i], b), rb))
            continue
        o = next(j for j, s in enumerate(ss) if id(s) == b)
        stride = (2, 2, 2) if i < 2 else (2, 2, 1)
        sstr = "".join(str(v) for v in stride)
        out.append((f"down{o + 1} s{sstr}", ss[o], i + 1,
                    sp.strided_spec(ts[i], ss[i], 3, stride, 1), rb[0]))
        out.append((f"inv{o + 1} s{sstr}", ss[i], o + 1,
                    sp.inverse_spec(ts[o], ss[o], 3, stride, 1), rb[1]))
    return out


def check_cyl_paths(report, runs, gen):
    """Phase 4's rows of the Cylinder3D paths (phases 3k, 3l): from a real
    frame of cyl-eval (B=1) and a real batch of cyl-train (B=2), every
    rulebook of the structures on both table kinds (K = 9 and 3, the
    x-width-1 kernels, strides (2,2,2) and (2,2,1) strided and inverse),
    the points' lookup on the stage-1 KeyTable through the merge kernel
    (the queries in point order, not raster order); the conv at K = 9 and
    K = 3 (the width-1 and the (1,1,3) kernels), the 17-class classifier
    64->17 and its dX 17->64, the (2,2,1) strided and inverse convs; at B=2
    the dW of the same shapes."""
    import torch
    from lidarseg3d_torch.models.backbones.cylinder3d import K13, K33
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.ops.rank_lookup import extended_cells

    for name in ("cyl_eval", "cyl_train"):
        if name not in runs:
            continue
        model, ex = runs[name]["model"], runs[name]["ex0"]
        with torch.no_grad():
            st, books = lidar_books(model, ex)
            vc = model.reader_mod(ex["points"], ex["point_valid"])[
                "point_vcoors"]
        B, V = st.features.shape[:2]
        ss = [books[f"s{i}"] for i in range(1, 6)]
        log(f"  {name} stage voxels: " + " ".join(
            f"s{i + 1}={s.num_voxels.tolist()}/{s.capacity}"
            for i, s in enumerate(ss)))
        other = {}
        for i, s in enumerate(ss, start=1):
            build = (co.build_rank_table if isinstance(books[f"t{i}"],
                                                       co.KeyTable)
                     else co.build_key_table)
            other[i] = build(s.coords, s.num_voxels, s.spatial_shape)
        rbs = cyl_rulebooks(books)
        for rname, s, i, spec, want in rbs:
            label = f"{name} {rname} B={s.batch_size} V={s.capacity}"
            table = books[f"t{i}"]
            timed = report if rname.startswith(("subm1", "down4", "inv4",
                                                "subm3")) else None
            if isinstance(table, co.KeyTable):
                check_rulebook_keys(timed, label, table, s, spec, want)
                check_rulebook_rank(None, label, other[i].packed, s, spec,
                                    want)
            else:
                check_rulebook_rank(timed, label, table.packed, s, spec,
                                    want)
                check_rulebook_keys(None, label, other[i], s, spec, want)
        log(f"  {name}: all {len(rbs)} rulebooks exact on both table kinds")
        # the point -> voxel lookup (coords.lookup_key): the points' cells,
        # clamped into the grid, in point order
        Z, Y, X = ss[0].spatial_shape
        cells = extended_cells(vc, ss[0].spatial_shape).clamp(
            0, Z * Y * (X + 2) - 1).to(torch.int32)[None].contiguous()
        check_merge(report, f"{name} points->voxels B={B} "
                    f"N={vc.shape[1]} {Z * Y * (X + 2)} cells",
                    books["t1"], cells)
        del other, cells

        def rnd(v, c):
            return torch.rand(B, v, c, generator=gen).to(DEV)

        down4 = books[(id(ss[2]), id(ss[3]))]
        c3, c4 = ss[2].capacity, ss[3].capacity
        rb31 = books[(id(ss[0]), (3, 1, 1))]
        rb113 = books[(id(ss[0]), (1, 1, 3))]
        if name == "cyl_eval":
            check_conv(report, f"{name} subm (1,3,3) K=9 V={V}", st.features,
                       books[(id(ss[0]), K13)], 16, 16, gen)
            check_conv(report, f"{name} subm (3,1,1) K=3 V={V}", rnd(V, 32),
                       rb31, 32, 32, gen)
            check_conv(report, f"{name} subm (1,1,3) K=3 V={V}", rnd(V, 32),
                       rb113, 32, 32, gen)
            check_conv(report, f"{name} classifier V={V}", rnd(V, 64),
                       books[(id(ss[0]), K33)], 64, 17, gen,
                       dtypes=("fp32",))
            check_conv(report, f"{name} strided (2,2,1) {c3}->{c4}",
                       rnd(c3, 128), down4[0], 128, 128, gen)
            check_conv(report, f"{name} inverse (2,2,1) {c4}->{c3}",
                       rnd(c4, 128), down4[1], 128, 128, gen)
        else:
            check_conv(report, f"dX of the classifier 17->64 {name} B={B} "
                       f"V={V}", rnd(V, 17), books[(id(ss[0]), K33)], 17,
                       64, gen, dx=True, dtypes=("fp32",))
            check_conv(report, f"dX of subm (3,1,1) 32->32 {name} B={B} "
                       f"V={V}", rnd(V, 32), rb31, 32, 32, gen, dx=True)
            check_dw(report, f"{name} subm (1,3,3) K=9 B={B} V={V}",
                     st.features, books[(id(ss[0]), K13)], 16, 16, gen)
            check_dw(report, f"{name} subm (3,1,1) K=3 B={B} V={V}",
                     rnd(V, 32), rb31, 32, 32, gen)
            check_dw(report, f"{name} classifier B={B} V={V}", rnd(V, 64),
                     books[(id(ss[0]), K33)], 64, 17, gen, dtypes=("fp32",))
            check_dw(report, f"{name} strided (2,2,1) B={B} {c3}->{c4}",
                     rnd(c3, 128), down4[0], 128, 128, gen)
        del books, st, vc


def check_outputs(ret, pred, N, ncls):
    import torch

    logits = ret["out_logits"]
    labels = pred["pred_point_sem_labels"]
    if tuple(logits.shape) != (1, N, ncls) or not torch.isfinite(logits).all():
        raise SystemExit(f"bad logits: shape {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    if tuple(labels.shape) != (1, N) or int(labels.min()) < 0 \
            or int(labels.max()) >= ncls:
        raise SystemExit(f"bad labels: shape {tuple(labels.shape)}, range "
                         f"[{int(labels.min())}, {int(labels.max())}]")
    for k in ("voxel_logits", "point_features_camera",
              "point_features_pcamera"):
        if not torch.isfinite(ret[k]).all():
            raise SystemExit(f"non-finite {k}")


def small_agreement(p):
    """The same small seeded model (ratio 1, small HRNet, fp32 image
    branch) on the path's grid, on the card and on the CPU (plain
    versions of every kernel): logits and labels must agree."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector

    cfg = syn.mseg3d_model_cfg(num_class=p["ncls"], ratio=1,
                               small_hrnet=True, pcr=p["pcr"], vsz=p["vsz"])
    b = syn.synthetic_mseg3d_batch(
        1, 4096, 4096, img_hw=(64, 128) if p["ncam"] == 1 else (64, 96),
        ncam=p["ncam"], seed=7, pcr=p["pcr"], vsz=p["vsz"])
    out = {}
    for dev in (DEV, "cpu"):
        m = build_detector(cfg, device=dev, seed=3)
        ex = syn.example_to_device(b, dev, syn.grid_shape(p["pcr"], p["vsz"]))
        ret, bat = m(ex)
        out[dev] = (ret["out_logits"].float().cpu(),
                    m.predict(ret, bat)["pred_point_sem_labels"].cpu())
    err = float((out[DEV][0] - out["cpu"][0]).abs().max())
    agree = float((out[DEV][1] == out["cpu"][1]).float().mean())
    log(f"  small model card vs CPU: max_abs_err(logits)={err:.3e} "
        f"labels agree {agree:.6f}")
    if err > 1e-3 or agree < 0.999:
        raise SystemExit("the small model on the card disagrees with the CPU")


def bf16_branch_check(model, cfg, ex):
    """The model's bf16 image branch against an fp32 HRNet + FCN head with
    the same weights, on the same images: within 0.1 * max |fp32|."""
    import torch
    from lidarseg3d_torch.models import build_img_backbone, build_img_head

    if model.img_backbone_mod.compute_dtype != torch.bfloat16 \
            or model.img_head_mod.compute_dtype != torch.bfloat16:
        raise SystemExit("the semnusc image branch is not bf16")
    plain = {k: dict(cfg[k]) for k in ("img_backbone", "img_head")}
    for c in plain.values():
        c.pop("compute_dtype")
    bb = build_img_backbone(plain["img_backbone"])
    hd = build_img_head(plain["img_head"])
    bb.load_state_dict(model.img_backbone_mod.state_dict())
    hd.load_state_dict(model.img_head_mod.state_dict())
    bb, hd = bb.to(DEV).eval(), hd.to(DEV).eval()
    with torch.inference_mode():
        got = model.image_branch(ex)
        images = ex["images"]
        B, ncam = images.shape[:2]
        x = images.reshape(B * ncam, *images.shape[2:]).permute(0, 3, 1, 2)
        want = hd(bb(x), batch_size=B)
    for k in IMG_KEYS:
        if got[k].dtype != torch.float32:
            raise SystemExit(f"bf16 branch output {k} is {got[k].dtype}")
        err = float((got[k] - want[k]).abs().max())
        scale = float(want[k].abs().max())
        log(f"  bf16 image branch vs fp32, same weights: {k} max_abs_err="
            f"{err:.3e} (max|fp32|={scale:.3e}, tol {TOL_BF16_BRANCH} rel)")
        if not err <= TOL_BF16_BRANCH * scale:
            raise SystemExit(f"bf16 image branch {k} deviates: {err} > "
                             f"{TOL_BF16_BRANCH}*{scale}")
    del bb, hd
    torch.cuda.empty_cache()


def run_path(name, p):
    """Phase 3 / 3b: one main path's counted run over the distinct scans,
    its checks, then timing. Returns a dict with the result, the launches
    per kernel over the counted run, the model and one example. It runs
    before any profiler session: an initialised profiler adds host time
    to every launch."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops import coords as co

    V, N = p["V"], p["N"]
    ishape = syn.grid_shape(p["pcr"], p["vsz"])
    cfg = syn.mseg3d_model_cfg(**p["cfg"])
    model = build_detector(cfg, device=DEV, seed=0)
    t0 = time.perf_counter()
    batches = [syn.synthetic_mseg3d_batch(1, V, N, img_hw=p["img_hw"],
                                          ncam=p["ncam"], seed=s,
                                          pcr=p["pcr"], vsz=p["vsz"])
               for s in range(NSCANS)]
    log(f"  host: {NSCANS} scans voxelized in "
        f"{time.perf_counter() - t0:.2f} s; grid {ishape}; voxels "
        f"{[int(b['num_voxels'][0]) for b in batches]}")
    coords = [b["coordinates"] for b in batches]
    if any((coords[i] == coords[j]).all() for i in range(NSCANS)
           for j in range(i)):
        raise SystemExit("synthetic scans share a coordinate set")
    exs = [syn.example_to_device(b, DEV, ishape) for b in batches]

    small_agreement(p)

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    for ex in exs:
        ret, bat = model(ex)
        check_outputs(ret, model.predict(ret, bat), N, p["ncls"])
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in ws.items()}
    log(f"  launches over {NSCANS} scans: {launches} (per forward "
        f"{p['per_forward']})")
    for k, n in launches.items():
        if n != NSCANS * p["per_forward"][k]:
            raise SystemExit(f"{name}: {k}: {n} launches, expected "
                             f"{NSCANS * p['per_forward'][k]}")

    with torch.inference_mode():
        books = model.backbone_mod.structures(
            model.lidar_input(exs[0]).structure)
    kinds = tuple("keys" if isinstance(books[f"t{i}"], co.KeyTable)
                  else "rank" for i in range(1, 5))
    log(f"  stage table kinds: {kinds}")
    if kinds != p["tables"]:
        raise SystemExit(f"{name}: table kinds {kinds}, expected "
                         f"{p['tables']}")
    del books
    if p["cfg"].get("img_bf16"):
        bf16_branch_check(model, cfg, exs[0])

    # per-scan latency: warm, then 2 rounds over the distinct scans
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2 * NSCANS):
        a, b = ev(), ev()
        a.record()
        ret, bat = model(exs[i % NSCANS])
        model.predict(ret, bat)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    p50 = times[len(times) // 2]
    mean = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  per-scan ms: p50 {p50:.2f}, mean {mean:.2f}, min {times[0]:.2f}, "
        f"max {times[-1]:.2f} -> {1000.0 / mean:.2f} scans/s; peak memory "
        f"{peak:.2f} GiB")

    # branch split, one scan at a time
    names = ["image", "vfe", "structures+rulebooks", "convs", "head+predict"]
    split = [0.0] * len(names)
    with torch.inference_mode():
        for i in range(2 * NSCANS):
            ex = exs[i % NSCANS]
            e = [ev() for _ in range(len(names) + 1)]
            e[0].record()
            img_out = model.image_branch(ex)
            e[1].record()
            st = model.lidar_input(ex)
            e[2].record()
            books = model.backbone_mod.structures(st.structure)
            e[3].record()
            bb_out = model.backbone_mod.convs(st, books)
            e[4].record()
            ret, bat = model.head(ex, bb_out, img_out)
            model.predict(ret, bat)
            e[5].record()
            torch.cuda.synchronize()
            if i >= NSCANS:  # the first round warms the split path
                for j in range(len(names)):
                    split[j] += e[j].elapsed_time(e[j + 1]) / NSCANS
    log("  split ms: " + ", ".join(f"{n} {t:.2f}"
                                   for n, t in zip(names, split)))
    result = dict(p50_ms=p50, mean_ms=mean, scans_per_s=1000.0 / mean,
                  peak_memory_gib=peak, split_ms=dict(zip(names, split)))
    return dict(result=result, launches=launches, model=model, ex0=exs[0],
                path=p)


def train_setup(model, opt_cfg, lr_cfg, total_steps, grad_clip, ishape):
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

    opt, _ = build_one_cycle_optimizer(opt_cfg, lr_cfg, total_steps,
                                       grad_clip=grad_clip)
    return (opt, tr.create_train_state(model, opt, seed=0),
            tr.make_train_step(model, opt, ishape))


def check_losses(ldict, what):
    import math

    vals = {k: float(v) for k, v in ldict.items()}
    bad = [k for k, v in vals.items() if not math.isfinite(v)]
    if bad or "grad_norm" not in vals or "loss" not in vals:
        raise SystemExit(f"{what}: non-finite or missing loss terms {bad}: "
                         f"{vals}")
    return vals


def run_train(t=TRAIN):
    """Phase 3c: the full-width training step. Returns the result, the
    launches per kernel over the counted steps, the model and one batch."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector

    B, V, N, steps = t["B"], t["V"], t["N"], t["steps"]
    ishape = syn.grid_shape()
    model = build_detector(syn.mseg3d_model_cfg(**t["cfg"]), device=DEV,
                           seed=0)
    nparam = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    batches = [syn.synthetic_mseg3d_batch(B, V, N, img_hw=t["img_hw"],
                                          seed=100 + s, with_labels=True)
               for s in range(steps + 1)]
    log(f"  host: {steps + 1} labelled batches of {B} scans voxelized in "
        f"{time.perf_counter() - t0:.2f} s; voxels "
        f"{[b['num_voxels'].tolist() for b in batches]}; "
        f"{nparam / 1e6:.2f} M parameters")
    coords = [b["coordinates"] for b in batches]
    if any((coords[i] == coords[j]).all() for i in range(len(coords))
           for j in range(i)):
        raise SystemExit("training batches share a coordinate set")
    exs = [tr.example_to_device(b, DEV) for b in batches]
    opt, state, step = train_setup(model, t["optimizer"], t["lr"],
                                   t["total_steps"], t["grad_clip"], ishape)

    state, ldict = step(state, exs[0])  # warm step
    check_losses(ldict, "warm step")
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in model.state_dict().items()}

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    times, last, history = [], {k: 0 for k in ws}, []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, steps + 1):
        t1 = time.perf_counter()
        state, ldict = step(state, exs[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        vals = check_losses(ldict, f"step {i}")
        history.append(vals)
        now = {k: w.launches for k, w in ws.items()}
        delta = {k: now[k] - last[k] for k in ws}
        last = now
        if delta != t["per_step"]:
            raise SystemExit(f"train step {i}: launches {delta}, expected "
                             f"{t['per_step']}")
        log(f"  step {i}: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in vals.items()))
    launches = dict(last)
    log(f"  launches over {steps} steps: {launches} (per step "
        f"{t['per_step']})")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # every parameter has a finite gradient and moved; BN statistics moved
    after = model.state_dict()
    for k, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise SystemExit(f"{k}: missing or non-finite gradient")
        if not torch.isfinite(p).all() or torch.equal(after[k], before[k]):
            raise SystemExit(f"{k}: parameter non-finite or did not move")
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    still = [k for k in stats if torch.equal(after[k], before[k])]
    if still or not stats:
        raise SystemExit(f"BN running statistics did not move: {still[:5]}")
    log(f"  {len(list(model.parameters()))} parameter tensors with finite "
        f"gradients, all moved; {len(stats)} BN running statistics moved")

    times.sort()
    p50 = times[len(times) // 2]
    mean = sum(times) / len(times)
    result = dict(p50_ms=p50, mean_ms=mean,
                  scans_per_s=1000.0 * B / mean, peak_memory_gib=peak,
                  last_losses=history[-1])
    log(f"  per-step ms (B={B}): p50 {p50:.2f}, mean {mean:.2f}, min "
        f"{times[0]:.2f}, max {times[-1]:.2f} -> {1000.0 * B / mean:.2f} "
        f"scans/s; peak memory {peak:.2f} GiB")

    # forward / backward / optimizer split (CUDA events) over the
    # same pieces make_train_step chains, after the counted steps
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    names = ["forward+loss", "backward", "optimizer"]
    split = [0.0] * 3
    reps = min(3, steps)
    for i in range(reps):
        e = [ev() for _ in range(4)]
        e[0].record()
        loss, _ = tr.forward_loss(state, exs[1 + i], ishape)
        e[1].record()
        loss.backward()
        e[2].record()
        tr.apply_gradients(state, opt)
        e[3].record()
        torch.cuda.synchronize()
        for j in range(3):
            split[j] += e[j].elapsed_time(e[j + 1]) / reps
    log("  split ms: " + ", ".join(f"{n} {v:.2f}"
                                   for n, v in zip(names, split)))
    result["split_ms"] = dict(zip(names, split))
    result["remat"] = remat_steps(t, exs[:2], ishape, peak)
    ex0 = dict(exs[1])
    ex0["input_shape"] = ishape
    return dict(result=result, launches=launches, model=model, ex0=ex0,
                state=state, step=step)


def bf16_group(name):
    if name.startswith("img_backbone_mod."):
        return "image backbone"
    return "image head" if name.startswith("img_head_mod.") \
        else "lidar+head"


def small_bf16_check():
    """One train step of a small seeded model with the image branch in
    bf16 (ratio 1, small HRNet with frozen_stages=3 and its BN on running
    statistics, no dropout) on one labelled batch, on the card and on the
    CPU: the loss terms, the gradient norm and the gradients by group
    within the bf16 limits (TOL_BF16_*); the CPU's same step with the
    image branch in fp32 is printed beside, the spread bf16 itself
    makes."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector

    b = syn.synthetic_mseg3d_batch(2, 4096, 4096, img_hw=(64, 128), seed=8,
                                   with_labels=True)
    out = {}
    for key, dev, bf16 in ((DEV, DEV, True), ("cpu", "cpu", True),
                           ("cpu fp32", "cpu", False)):
        cfg = syn.mseg3d_model_cfg(ratio=1, small_hrnet=True, img_bf16=bf16)
        cfg["img_backbone"].update(frozen_stages=3, norm_eval=True)
        cfg["point_head"]["model_cfg"]["DP_RATIO"] = 0
        m = build_detector(cfg, device=dev, seed=3)
        _, state, step = train_setup(
            m, dict(type="adam", wd=0.01), dict(lr_max=2e-3), 12, 35.0,
            syn.grid_shape())
        state, ldict = step(state, tr.example_to_device(b, dev))
        out[key] = (check_losses(ldict, f"small bf16 step on {key}"),
                    {k: p.grad.detach().double().cpu()
                     for k, p in m.named_parameters() if p.grad is not None})
    cpu = out["cpu"]

    def by_group(side, ref):
        acc = {g: [0.0, 0.0] for g in TOL_BF16_GRAD}
        for k, want in ref[1].items():
            a = acc[bf16_group(k)]
            a[0] += float((side[1][k] - want).square().sum())
            a[1] += float(want.square().sum())
        return {g: (n / d) ** 0.5 for g, (n, d) in acc.items()}

    got, spread = by_group(out[DEV], cpu), by_group(out["cpu fp32"], cpu)
    loss = {k: abs(out[DEV][0][k] - v) / abs(v) for k, v in cpu[0].items()}
    log("  small bf16 train step card vs CPU: loss terms, relative: "
        + ", ".join(f"{k} {v:.2e}" for k, v in loss.items())
        + f" (limits {TOL_BF16_LOSS}, grad_norm {TOL_BF16_GRAD_NORM})")
    log("    gradients, relative L2 by group: " + ", ".join(
        f"{g} {got[g]:.3e} (limit {TOL_BF16_GRAD[g]}; the CPU's fp32 image "
        f"branch against its bf16 one {spread[g]:.3e})" for g in got))
    bad = [k for k, v in loss.items() if v > (
        TOL_BF16_GRAD_NORM if k == "grad_norm" else TOL_BF16_LOSS)]
    bad += [g for g, e in got.items() if not e <= TOL_BF16_GRAD[g]]
    if bad:
        raise SystemExit(f"small bf16 train step: the card disagrees with "
                         f"the CPU in {bad}")
    return dict(loss_rel=loss, grads=got, fp32_spread=spread)


def w48_check():
    """HRNet-w48 (the w48 ``extra`` of the port's mmcv converter: 48 / 96
    / 192 / 384 channels) from the same seeded weights on the card and on
    the CPU: at one 640x960 image the forward in evaluation and a training
    forward (batch statistics), outputs and running statistics card vs
    CPU within TOL_W48_OUT of their max; at W48_GRAD_HW the backward of a
    fixed linear loss of the four outputs on the card, on the CPU and on
    the CPU in float64: the card's worst relative L2 distance of a
    gradient from float64 within TOL_W48_GRAD times the CPU fp32's (plus
    1e-4), and, as the control that limit must fail, the card's with TF32
    convolutions. Then the card's forward and a training step at 640x960
    are timed, with the peak memory."""
    import copy

    import torch
    from lidarseg3d_torch.models import build_img_backbone
    from lidarseg3d_torch.tools.convert_hrnet_checkpoint import HRNET_EXTRA

    torch.manual_seed(48)
    cpu = build_img_backbone(dict(type="HRNet",
                                  extra=HRNET_EXTRA[48])).cpu()
    card = copy.deepcopy(cpu).to(DEV)
    nparam = sum(p.numel() for p in cpu.parameters())
    gen = torch.Generator().manual_seed(48)
    x = torch.rand(1, 3, *W48_HW, generator=gen) * 4 - 2
    res = {"parameters_m": nparam / 1e6}

    def rel_max(got, want):
        return max(float((g.double().cpu() - w.double()).abs().max()
                         / w.double().abs().max().clamp(min=1e-30))
                   for g, w in zip(got, want))

    def stats(m):
        return [v for k, v in m.state_dict().items() if "running" in k]

    with torch.no_grad():
        err = rel_max(card.eval()(x.to(DEV)), cpu.eval()(x))
        s0 = [v.clone() for v in stats(cpu)]
        terr = rel_max(card.train()(x.to(DEV)), cpu.train()(x))
        serr = rel_max(stats(card), stats(cpu))
    for m in (card, cpu):  # back to the seeded statistics
        for v, v0 in zip(stats(m), s0):
            v.copy_(v0)

    xg = torch.rand(1, 3, *W48_GRAD_HW, generator=gen) * 4 - 2
    ws = None

    def grads(m, dev, dt):
        nonlocal ws
        m = copy.deepcopy(m).to(dev, dt).train()
        outs = m(xg.to(dev, dt))
        if ws is None:
            ws = [torch.randn(o.shape, generator=gen) for o in outs]
        sum((o * w.to(dev, dt)).sum() for o, w in zip(outs, ws)).backward()
        return {k: p.grad.double().cpu() for k, p in m.named_parameters()}

    g64 = grads(cpu, "cpu", torch.float64)
    sides = {"card": grads(card, DEV, torch.float32),
             "cpu": grads(cpu, "cpu", torch.float32)}
    torch.backends.cudnn.allow_tf32 = True
    try:
        sides["card tf32"] = grads(card, DEV, torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    dist = {key: max(float((g[k] - w).norm() / w.norm())
                     for k, w in g64.items())
            for key, g in sides.items()}
    limit = TOL_W48_GRAD * dist["cpu"] + 1e-4

    # timing at 640x960: the forward, then a second training step (cuDNN
    # has chosen its algorithms in the first)
    with torch.no_grad():
        card.eval()(x.to(DEV))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card(x.to(DEV))
        torch.cuda.synchronize()
        res["forward_ms"] = (time.perf_counter() - t0) * 1e3

    def train_step():
        outs = card.train()(x.to(DEV))
        sum(o.float().mean() for o in outs).backward()

    train_step()
    card.zero_grad()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step()
    torch.cuda.synchronize()
    res["train_step_ms"] = (time.perf_counter() - t0) * 1e3
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res.update(eval_out_err=err, train_out_err=terr, stats_err=serr,
               grads_vs_float64=dist, grads_limit=limit)
    log(f"  HRNet-w48 ({nparam / 1e6:.2f} M parameters) at "
        f"{W48_HW[1]}x{W48_HW[0]}, card vs CPU: eval outputs {err:.2e}, "
        f"training outputs {terr:.2e}, running statistics {serr:.2e} of "
        f"their max (limit {TOL_W48_OUT}); gradients at "
        f"{W48_GRAD_HW[1]}x{W48_GRAD_HW[0]} against float64 (worst "
        f"relative L2 of a tensor): card {dist['card']:.3e}, CPU fp32 "
        f"{dist['cpu']:.3e} (limit {TOL_W48_GRAD}x the CPU's + 1e-4 = "
        f"{limit:.3e}); control, the card with TF32 convolutions "
        f"{dist['card tf32']:.3e} ("
        f"{'fails' if dist['card tf32'] > limit else 'passes'} the limit); "
        f"card: forward {res['forward_ms']:.2f} ms, a training "
        f"forward+backward {res['train_step_ms']:.2f} ms, peak "
        f"{res['peak_memory_gib']:.2f} GiB")
    if max(err, terr, serr) > TOL_W48_OUT or not dist["card"] <= limit:
        raise SystemExit("HRNet-w48: the card disagrees with the CPU")
    return res


def run_bf16_w48():
    """Phase 3q: 3c's full-width step with the bf16 image branch (its
    launches, every parameter moved, remat on too), the small bf16 step
    card vs CPU, and HRNet-w48."""
    t0 = time.perf_counter()
    run = run_train(TRAIN_BF16)
    t1 = time.perf_counter()
    run["result"]["small_card_vs_cpu"] = small_bf16_check()
    t2 = time.perf_counter()
    w48 = w48_check()
    log(f"  seconds: the bf16 step {t1 - t0:.1f}, the small bf16 check "
        f"{t2 - t1:.1f}, HRNet-w48 {time.perf_counter() - t2:.1f}")
    return {"train_bf16": run, "w48": dict(
        result=w48, launches={k: 0 for k in wrappers()})}


def remat_steps(t, exs, ishape, peak_off):
    """The same training step with every remat option on (HRNet's
    with_cp, ACT_REMAT of the UNet's residual stacks and of the SFFM
    layers): one warm step, then one counted step; its peak memory beside
    the counted steps' without remat, and its launches (the recomputed
    blocks run their convs again in the backward)."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector

    cfg = syn.mseg3d_model_cfg(**t["cfg"])
    cfg["img_backbone"]["with_cp"] = True
    cfg["backbone"]["model_cfg"]["ACT_REMAT"] = True
    cfg["point_head"]["model_cfg"]["ACT_REMAT"] = True
    model = build_detector(cfg, device=DEV, seed=0)
    _, state, step = train_setup(model, t["optimizer"], t["lr"],
                                 t["total_steps"], t["grad_clip"], ishape)
    check_losses(step(state, exs[0])[1], "remat warm step")
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_losses(step(state, exs[1])[1], "remat step")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: w.launches for k, w in ws.items()}
    log(f"  with remat on (with_cp, ACT_REMAT): one step {ms:.2f} ms, peak "
        f"memory {peak:.2f} GiB (without: {peak_off:.2f}); launches "
        f"{launches}")
    del model, state, step
    torch.cuda.empty_cache()
    return dict(step_ms=ms, peak_memory_gib=peak, launches=launches)


def small_train_check():
    """One train step of the same small seeded model (ratio 1, small HRNet,
    no dropout) on one labelled batch, on the card (kernels) and on the
    CPU (plain versions): loss terms and gradients must agree. Both are
    also measured against the same step in float64 on the CPU (plain
    versions), the reference of fp32's own noise. Then the card goes on
    for eleven more steps on that batch, which must lower the loss."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector

    cfg = syn.mseg3d_model_cfg(ratio=1, small_hrnet=True)
    cfg["point_head"]["model_cfg"]["DP_RATIO"] = 0
    b = syn.synthetic_mseg3d_batch(2, 4096, 4096, img_hw=(64, 128), seed=7,
                                   with_labels=True)
    out = {}
    for key, dev, dt in ((DEV, DEV, torch.float32),
                         ("cpu", "cpu", torch.float32),
                         ("cpu64", "cpu", torch.float64)):
        m = build_detector(cfg, device=dev, seed=3).to(dt)
        _, state, step = train_setup(
            m, dict(type="adam", wd=0.01), dict(lr_max=2e-3), 12, 35.0,
            syn.grid_shape())
        ex = {k: v.to(dt) if v.is_floating_point() else v
              for k, v in tr.example_to_device(b, dev).items()}
        state, ldict = step(state, ex)
        out[key] = (check_losses(ldict, f"small step on {key}"),
                    {k: p.grad.detach().double().cpu()
                     for k, p in m.named_parameters()}, state, step, ex)
    card, cpu = out[DEV], out["cpu"]
    ref = out.pop("cpu64")[1]
    for name, side in (("card", card[1]), ("CPU fp32", cpu[1])):
        for group, limits in TOL_TRAIN_GRAD.items():
            wl2, wmax = ("", 0.0), ("", 0.0)
            for k, want in ref.items():
                if ("image" if k.startswith("img_") else "lidar+head") \
                        != group:
                    continue
                scale = float(want.abs().max())
                if scale <= 1e-7 * cpu[0]["grad_norm"]:
                    continue  # analytically zero: rounding noise only
                d = side[k] - want
                wl2 = max(wl2, (k, float(d.norm() / want.norm())),
                          key=lambda kv: kv[1])
                wmax = max(wmax, (k, float(d.abs().max()) / scale),
                           key=lambda kv: kv[1])
            log(f"    {name} vs float64, {group}: worst relative L2 "
                f"{wl2[1]:.2e} ({wl2[0]}), worst max-entry {wmax[1]:.2e} "
                f"({wmax[0]}); card-vs-CPU limits {limits}")
    for k, want in cpu[0].items():
        if abs(card[0][k] - want) > TOL_TRAIN_LOSS * abs(want):
            raise SystemExit(f"small train step: {k} {card[0][k]} on the "
                             f"card, {want} on the CPU")
    floor = 1e-8 * cpu[0]["grad_norm"]
    worst = {g: [("", 0.0), ("", 0.0)] for g in TOL_TRAIN_GRAD}
    bad, arbitrated = [], []

    def closer_to_float64(k, measure):
        """The card's gradient is at least as close to the float64 step's
        as the CPU's fp32 one by ``measure`` (TOL_TRAIN_GRAD's note)."""
        exact = ref[k]
        if not exact.any():
            return False
        return measure(card[1][k] - exact) <= measure(cpu[1][k] - exact)

    for k, want in cpu[1].items():
        group = "image" if k.startswith("img_") else "lidar+head"
        tol_l2, tol_max = TOL_TRAIN_GRAD[group]
        scale = float(want.abs().max())
        err = float((card[1][k] - want).abs().max())
        l2 = (float((card[1][k] - want).norm() / want.norm())
              if scale > 10 * floor else 0.0)
        beyond = [f for f, out in ((lambda d: float(d.norm()), l2 > tol_l2),
                                   (lambda d: float(d.abs().max()),
                                    err > tol_max * scale + floor)) if out]
        if beyond:
            if all(closer_to_float64(k, f) for f in beyond):
                arbitrated.append(f"{k} ({l2:.3e} in relative L2, "
                                  f"{err / max(scale, 1e-30):.3e} of its max)")
            else:
                bad.append(f"{k}: off by {err:.3e} at max {scale:.3e}, "
                           f"{l2:.3e} in relative L2 norm")
        if scale <= 10 * floor:
            continue
        w = worst[group]
        w[0] = max(w[0], (k, l2), key=lambda kv: kv[1])
        w[1] = max(w[1], (k, err / scale), key=lambda kv: kv[1])
    log(f"  small train step card vs CPU: loss {card[0]['loss']:.6f} / "
        f"{cpu[0]['loss']:.6f}, grad_norm {card[0]['grad_norm']:.5f} / "
        f"{cpu[0]['grad_norm']:.5f}; {len(cpu[1])} gradients")
    for group, (wl2, wmax) in worst.items():
        log(f"    {group}: worst relative L2 {wl2[1]:.2e} ({wl2[0]}), worst "
            f"max-entry {wmax[1]:.2e} ({wmax[0]}); limits "
            f"{TOL_TRAIN_GRAD[group]}")
    if arbitrated:
        log(f"    {len(arbitrated)} beyond the card-vs-CPU limits but at "
            "least as close as the CPU's to the float64 step: "
            + "; ".join(arbitrated[:10]))
    if bad:
        raise SystemExit("small train step: gradients on the card disagree "
                         "with the CPU:\n  " + "\n  ".join(bad[:10]))
    _, _, state, step, ex = card
    losses = [card[0]["loss"]]
    for _ in range(11):
        state, ldict = step(state, ex)
        losses.append(check_losses(ldict, "small descent")["loss"])
    log("  12 steps on one small batch, loss: "
        + " ".join(f"{v:.3f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise SystemExit("twelve steps on one batch did not lower the loss")


def calibrate_bn(model, ex):
    """Set every BN layer's running statistics to the (masked) batch
    statistics of its input in one evaluation forward of ``ex``, each
    layer seeing the output of layers already set: the data-fitted
    statistics a trained model carries. build_detector leaves mean 0 and
    variance 1, with which a seeded model's activations drift into one
    shared direction and it gives one label to every point (class 8 at
    the published config's 0.1 m size), and a comparison of labels would
    say little."""
    import torch
    from lidarseg3d_torch.models.layers import MaskedBatchNorm

    def set_stats(bn, args, kwargs):
        x = args[0].float()
        mask = args[1] if len(args) > 1 else kwargs.get("mask")
        cd = bn.channel_dim % x.dim()
        dims = [d for d in range(x.dim()) if d != cd]
        mf = (torch.ones_like(x) if mask is None
              else mask.to(x.dtype).unsqueeze(cd).expand_as(x))
        cnt = mf.sum(dims).clamp(min=1.0)
        mean = (x * mf).sum(dims) / cnt
        shape = [1] * x.dim()
        shape[cd] = -1
        var = ((x - mean.view(shape)) ** 2 * mf).sum(dims) / cnt
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(set_stats, with_kwargs=True)
             for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    try:
        with torch.no_grad():
            model.eval()(dict(ex))
    finally:
        for h in hooks:
            h.remove()
    return model


def with_loader(cfg_path, path, mode):
    """A copy of the config file at ``path`` whose loader runs in ``mode``
    (the published one otherwise). The shm workers' start costs ~10-12 s a
    loader on the card's host (spawned interpreters importing torch),
    more than a lidar-only run of a few frames takes, so the runs whose
    subject is not the loader take threads."""
    with open(cfg_path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text + f"\ndata['worker_mode'] = {mode!r}\n")
    return path


def caps(cfg):
    """The loader's capacities of a config, the tools' defaults where it
    names none (a points-only config names no voxel capacity)."""
    cap = cfg.get("capacity", {})
    return dict(max_voxels=cap.get("max_voxels", 160000),
                max_points=cap.get("max_points", 140000))


def lidar_books(model, ex):
    """The sparse input of an example and its backbone's structures, tables
    and rulebooks (None and None for a dense-BEV model)."""
    r = model.lidar_input(ex)
    st = r.get("sparse_tensor") if isinstance(r, dict) else r
    if st is None:
        return None, None
    return st, model.backbone_mod.structures(st.structure)


def stage_tables(books):
    """The stage tables t1, t2, ... of a backbone's structures."""
    out, i = [], 1
    while f"t{i}" in books:
        out.append(books[f"t{i}"])
        i += 1
    return out


def first_example(dataset, cap, ishape, device):
    """Frame 0 of ``dataset`` through the port's loader, on ``device``."""
    from lidarseg3d_torch.apis.train import example_to_device
    from lidarseg3d_torch.datasets import SegDataLoader

    with SegDataLoader(dataset, 1, cap["max_voxels"], cap["max_points"],
                       shuffle=False, drop_last=False,
                       num_workers=1) as loader:
        ex = example_to_device(next(loader.epoch(0)), device)
    ex["input_shape"] = ishape
    return ex


def predicted_classes(detections, ncls, what):
    """The predicted-class histogram over every frame, printed; fails
    unless the labels spread: at least MIN_PRED_CLASSES classes besides
    the ignore class 0 (which evaluation drops), at least
    MIN_SHARE_NOT_0 of the points outside class 0, and no class above
    MAX_SHARE_ONE_CLASS of the points."""
    import numpy as np

    counts = sum(np.bincount(p["pred_point_sem_labels"], minlength=ncls)
                 for p in detections.values())
    total = int(counts.sum())
    others = int((counts[1:] > 0).sum())
    log(f"  {what}: predicted classes over {total} points: "
        + ", ".join(f"{c}: {int(n)}" for c, n in enumerate(counts) if n))
    if others < MIN_PRED_CLASSES or counts[1:].sum() < MIN_SHARE_NOT_0 \
            * total or counts.max() > MAX_SHARE_ONE_CLASS * total:
        raise SystemExit(f"{what}: the labels do not spread ({others} "
                         "classes besides 0)")
    return counts


def label_agreement(got, want):
    """Share of points whose labels agree between two detections dicts
    of the same frames, and the point count."""
    agree = total = 0
    for token, w in want.items():
        g = got[token]["pred_point_sem_labels"]
        agree += int((g == w["pred_point_sem_labels"]).sum())
        total += g.size
    return agree / max(total, 1), total


def host_pipeline_ms(dataset, cap):
    """Host milliseconds per frame of each stage of the dataset's pipeline
    (val or train, as its test_mode says; frame i draws from a generator
    seeded with i) and of the collate, one frame at a time on one
    thread, over the dataset's first PIPELINE_FRAMES frames."""
    import numpy as np
    from lidarseg3d_torch.datasets import collate_segnet

    ms = {}
    n = min(len(dataset), PIPELINE_FRAMES)
    for i in range(n):
        info = dataset.load_infos(i)
        sample = {"mode": "val" if dataset.test_mode else "train",
                  "rng": np.random.default_rng(i),
                  "nsweeps": dataset.nsweeps,
                  "metadata": {"token": info["token"],
                               "num_point_features":
                               dataset._num_point_features}}
        for t in dataset.pipeline.transforms:
            t0 = time.perf_counter()
            sample, info = t(sample, info)
            k = type(t).__name__
            ms[k] = ms.get(k, 0.0) + (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        collate_segnet(sample if isinstance(sample, list) else [sample],
                       cap["max_voxels"], cap["max_points"])
        ms["collate"] = ms.get("collate", 0.0) + (time.perf_counter()
                                                  - t0) * 1e3
    ms = {k: v / n for k, v in ms.items()}
    ms["total"] = sum(ms.values())
    return ms


def jpeg_read_ms(dataset):
    """Host milliseconds of one read_jpeg_bgr of frame 0's first camera,
    and of its Huffman decoding alone (the C helper), the mean of 5."""
    from lidarseg3d_torch.datasets.pipelines import jpeg_read as jr

    info = dataset.load_infos(0)
    cam = (info["cam"].get("chan") or info["cam"]["names"])[0]
    path = info["cam_paths"][cam]
    with open(path, "rb") as f:
        data = f.read()
    hw = jr.decode_jpeg_bgr(data).shape[:2]
    real, scans = jr._Frame.scan, []

    def timed(self, seg, buf):
        t0 = time.perf_counter()
        out = real(self, seg, buf)
        scans.append(time.perf_counter() - t0)
        return out

    jr._Frame.scan = timed
    try:
        t0 = time.perf_counter()
        for _ in range(5):
            jr.decode_jpeg_bgr(data)
        total = (time.perf_counter() - t0) / 5
    finally:
        jr._Frame.scan = real
    return dict(image_ms=total * 1e3, huffman_ms=sum(scans) / 5 * 1e3,
                bytes=len(data), hw=list(hw))


def dataset_in(cfg, split, tmp, tta=False):
    """The config's split as a dataset whose relative paths are taken
    under ``tmp`` (where the tool runs); with ``tta``, under the entry
    point's --tta pipeline (a frame is the list of its variants)."""
    from lidarseg3d_torch.datasets import build_dataset
    from lidarseg3d_torch.tools.test import tta_dataset_cfg

    d = cfg.data[split].to_dict()
    for k in ("root_path", "info_path"):
        if k in d:
            d[k] = os.path.join(tmp, d[k])
    if tta:
        d = tta_dataset_cfg(d, cfg.tta_cfg.to_dict())
    return build_dataset(d)


def write_nusc_tree(tmp, cfg, spec):
    """A seeded nuScenes tree at the config's root path under ``tmp``, its
    infos by the entry point tools.create_data (--cams, unless ``spec``
    says the config reads no camera: then the tree has none) and its check
    (--dry-data); -> seconds the tree took to write."""
    from lidarseg3d_torch.datasets.nuscenes.metadata import CAM_CHANS
    from lidarseg3d_torch.synthetic import write_semnusc_tree
    from lidarseg3d_torch.tools import create_data

    root = os.path.join(tmp, cfg.data.val.root_path)
    t0 = time.perf_counter()
    cams = spec.get("cams", True)
    write_semnusc_tree(root, scenes=spec["scenes"], samples=spec["samples"],
                       points=spec["points"], seed=spec["seed"],
                       max_range=spec.get("max_range", 50.0),
                       cams=CAM_CHANS if cams else ())
    secs = time.perf_counter() - t0
    flag = ["--cams"] if cams else []
    create_data.main(["semanticnusc", "--root", root, *flag])
    create_data.main(["semanticnusc", "--root", root, "--dry-data", *flag])
    return secs


_WAYMO_ROOT = []


def link_waymo_tree(tmp, cfg):
    """The seeded SemanticWaymo tree (WAYMO_TREE; full published sizes:
    five JPEG cameras a frame) at the config's data_root under ``tmp``: a
    link to one tree written on first use and removed when the script
    ends; -> the seconds this call spent writing it."""
    import atexit
    import shutil
    import tempfile

    from lidarseg3d_torch.synthetic import write_semanticwaymo_tree

    t0 = time.perf_counter()
    if not _WAYMO_ROOT:
        root = tempfile.mkdtemp(prefix="waymo_tree_")
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        write_semanticwaymo_tree(root, splits=("training", "validation"),
                                 frames=WAYMO_TREE["frames"],
                                 seed=WAYMO_TREE["seed"])
        _WAYMO_ROOT.append(root)
    link = os.path.join(tmp, cfg.data_root)
    os.makedirs(os.path.dirname(link), exist_ok=True)
    os.symlink(_WAYMO_ROOT[0], link)
    return time.perf_counter() - t0


def waymo_frame_points(ds, token):
    """The point count of a SemanticWaymo frame (all its lidars)."""
    import pickle

    with open(ds._path(ds._by_token[token]), "rb") as f:
        return len(pickle.load(f)["lidars"]["points_xyz"])


def waymo_tree_text(split):
    import pickle

    path = os.path.join(_WAYMO_ROOT[0], f"infos_{split}_01sweeps_segdet.pkl")
    with open(path, "rb") as f:
        infos = pickle.load(f)
    n = []
    for info in infos:
        with open(info["path"], "rb") as f:
            n.append(len(pickle.load(f)["lidars"]["points_xyz"]))
    return (f"{len(infos)} {split} frames of {min(n)}-{max(n)} points (a "
            "TOP lidar of 64 x 2650 with second returns, four short-range "
            "lidars) and five JPEGs (3 x 1920x1280, 2 x 1920x886)")


def eval_card_vs_cpu(tmp):
    """Phase 3d's agreement on the mini config (frozen_stages=3): the
    entry point on the card and on the CPU, from one seeded checkpoint
    with calibrated BN statistics and a small tree: labels agree on at
    least 99.9% of the points and the two mIoUs are within 0.1 point."""
    from lidarseg3d_torch.apis.train import TrainState, save_checkpoint
    from lidarseg3d_torch.datasets import build_dataset
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.synthetic import (write_eval_config,
                                            write_semantickitti_tree)
    from lidarseg3d_torch.tools import test as tool
    from lidarseg3d_torch.utils.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    data_root = os.path.join(tmp, "mini", "sequences")
    work = os.path.join(tmp, "mini", "work")
    # 20 frames: near-ties of the spread labels flip on about 1 point in
    # 2,000 between the card and the CPU, and 3 frames (4,000 points) left
    # the 99.9% limit a margin of a few points
    write_semantickitti_tree(data_root, ("00",), frames=20,
                             points=(1200, 1500), seed=5,
                             image_hw=(64, 128), max_range=6.0)
    cfg_path = with_loader(
        write_eval_config(os.path.join(tmp, "mini", "mini.py"),
                          os.path.join(here, EVAL["mini"]), data_root),
        os.path.join(tmp, "mini", "mini_thread.py"), "thread")
    cfg = Config.fromfile(cfg_path)
    model = build_detector(cfg.model.to_dict(), device="cpu", seed=3)
    calibrate_bn(model, first_example(build_dataset(cfg.data.val.to_dict()),
                                      cfg.capacity, tool.input_shape_of(cfg),
                                      "cpu"))
    save_checkpoint(work, TrainState(0, model, None, None), epoch=1)
    out = {dev: tool.main([cfg_path, "--checkpoint", work, "--work_dir",
                           work, "--device", dev])
           for dev in (DEV, "cpu")}
    for dev in (DEV, "cpu"):
        predicted_classes(out[dev]["detections"], EVAL["ncls"],
                          f"mini config on {dev}")
    share, total = label_agreement(out[DEV]["detections"],
                                   out["cpu"]["detections"])
    mious = [out[d]["results"]["results"]["mIoU"] for d in (DEV, "cpu")]
    log(f"  mini config (frozen_stages=3) card vs CPU through the entry "
        f"point: {len(out['cpu']['detections'])} frames, {total} points, "
        f"labels agree {share:.6f}, mIoU {mious[0]:.4f} / {mious[1]:.4f} "
        f"(limits {MIN_LABEL_AGREE}, {MAX_MIOU_POINTS} point)")
    if total == 0 or share < MIN_LABEL_AGREE \
            or not abs(mious[0] - mious[1]) <= MAX_MIOU_POINTS:
        raise SystemExit("the entry point on the card disagrees with the "
                         "CPU on the mini config")
    return dict(label_agreement=share, miou_card=mious[0],
                miou_cpu=mious[1])


def write_frame0(e, cfg, tmp, one):
    """Frame 0 of the eval tree alone, at its published size, for the
    entry point run in ``one``: SemanticKITTI writes the same first frame
    again (the same seed draws it), nuScenes and SemanticWaymo an info
    file of frame 0's info (its paths point into the tree under
    ``tmp``)."""
    import pickle

    if "scenes" not in e and not e.get("waymo"):
        from lidarseg3d_torch.synthetic import write_semantickitti_tree

        write_semantickitti_tree(os.path.join(one, cfg.data_root), ("08",),
                                 frames=1, points=e["points"],
                                 seed=e["seed"], image_hw=e["image_hw"],
                                 max_range=e["max_range"])
        return
    src = os.path.join(tmp, cfg.data.val.info_path)
    dst = os.path.join(one, cfg.data.val.info_path)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(src, "rb") as f, open(dst, "wb") as g:
        pickle.dump(pickle.load(f)[:1], g)


def published_frame_on_cpu(e, cfg_path, cfg, tmp, work, card, phase,
                           args=()):
    """Frame 0 of the eval tree, at its published size, through the entry
    point on the CPU (the kernels' plain versions) from the same
    checkpoint and with the same ``args`` (--tta): its labels agree with
    the card's on at least 99.9% of the points and its mIoU is within 0.1
    point of the card's on that frame."""
    import shutil
    import tempfile

    from lidarseg3d_torch.tools import test as tool

    one = tempfile.mkdtemp(prefix="frame0_")
    try:
        write_frame0(e, cfg, tmp, one)
        # one frame: the loader's threads (no shm workers to spawn)
        cfg_one = with_loader(cfg_path, os.path.join(one, "frame0.py"),
                              "thread")
        cwd = os.getcwd()
        os.chdir(one)
        try:
            t0 = time.perf_counter()
            cpu = tool.main([cfg_one, "--checkpoint", work, "--work_dir",
                             os.path.join(one, "work"), "--device", "cpu",
                             *args])
            secs = time.perf_counter() - t0
            ds = dataset_in(cfg, "val", one)
            mine = {t: card[t] for t in cpu["detections"]}
            miou_card = ds.evaluation(mine)[0]["results"]["mIoU"]
        finally:
            os.chdir(cwd)
    finally:
        shutil.rmtree(one, ignore_errors=True)
    predicted_classes(cpu["detections"], e["ncls"],
                      "published config, frame 0 on the CPU")
    share, total = label_agreement(mine, cpu["detections"])
    miou_cpu = cpu["results"]["results"]["mIoU"]
    log(f"  published config, frame 0 card vs CPU through the entry point "
        f"{' '.join(args)} ({secs:.1f} s on the CPU): {total} points, "
        f"labels agree {share:.6f}, mIoU {miou_card:.4f} / {miou_cpu:.4f} (limits "
        f"{MIN_LABEL_AGREE}, {MAX_MIOU_POINTS} point)")
    if total == 0 or share < MIN_LABEL_AGREE \
            or not abs(miou_card - miou_cpu) <= MAX_MIOU_POINTS:
        raise SystemExit(f"phase {phase}: the entry point on the card "
                         "disagrees with the CPU on the published config's "
                         "frame 0")
    return dict(label_agreement=share, miou_card=miou_card,
                miou_cpu=miou_cpu, cpu_seconds=secs)


def run_eval_path(e=EVAL, phase="3d"):
    """Phases 3d / 3f / 3h / 3j: a published config evaluated through the
    entry point (lidarseg3d_torch.tools.test main, in-process,
    --speed_test, and --tta where ``e`` says so) on a seeded tree
    (SemanticKITTI: sequence 08 of PNG frames; nuScenes: a val scene of
    JPEG cameras with the infos of tools.create_data), with its checks;
    then the device histogram (without TTA), the host pipeline's time,
    frame 0 on the CPU through the same entry point, and (where ``e``
    names a mini config) the card against the CPU on it. Returns the run
    for phases 4 and 5; under TTA its example is one frame's variant
    rows."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from lidarseg3d_torch.apis import eval as ev
    from lidarseg3d_torch.apis.train import TrainState, save_checkpoint
    from lidarseg3d_torch.core.seg_metrics import fast_hist
    from lidarseg3d_torch.datasets import SegDataLoader, default_worker_mode
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.synthetic import write_semantickitti_tree
    from lidarseg3d_torch.tools import test as tool
    from lidarseg3d_torch.utils.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(here, e["config"])
    cfg = Config.fromfile(cfg_path)
    cap, ishape = caps(cfg), tool.input_shape_of(cfg)
    nusc, waymo = "scenes" in e, bool(e.get("waymo"))
    tta = bool(e.get("tta"))
    args = ["--tta"] if tta else []
    rows = int(cfg.tta_cfg.num_tta_tranforms) if tta else 1
    tmp = tempfile.mkdtemp(prefix=f"eval_{phase}_")
    if e.get("loader"):
        cfg_path = with_loader(cfg_path, os.path.join(tmp, "cfg.py"),
                               e["loader"])
        cfg = Config.fromfile(cfg_path)
    try:
        # the config's paths are relative: the tree goes under tmp and the
        # entry point runs with tmp as its working directory
        if waymo:
            secs = link_waymo_tree(tmp, cfg)
            what = waymo_tree_text("validation")
        elif nusc:
            secs = write_nusc_tree(tmp, cfg, e)
            what = (f"{len(e['scenes'])} val scene(s) of {e['samples']} "
                    f"key frames, {e['points'][0]}-{e['points'][1]} points "
                    + ("and six 1600x900 JPEGs each" if e.get("cams", True)
                       else "each, no camera"))
        else:
            t0 = time.perf_counter()
            write_semantickitti_tree(os.path.join(tmp, cfg.data_root),
                                     ("08",), frames=e["frames"],
                                     points=e["points"], seed=e["seed"],
                                     image_hw=e["image_hw"],
                                     max_range=e["max_range"])
            secs = time.perf_counter() - t0
            H, W = e["image_hw"]
            what = (f"sequence 08, {e['frames']} frames of "
                    f"{e['points'][0]}-{e['points'][1]} points and {W}x{H} "
                    "PNGs")
        nframes = e["samples"] * len(e["scenes"]) if nusc else e["frames"]
        log(f"  tree: {what} written in {secs:.2f} s; grid {ishape}, "
            f"capacity {dict(cap)}, loader {default_worker_mode(cfg.data)} "
            f"x{cfg.data.workers_per_gpu}")
        ds = dataset_in(cfg, "val", tmp)
        model = build_detector(cfg.model.to_dict(), device=DEV, seed=0)
        hb = getattr(model, "img_backbone_mod", None)
        if hb is not None and (hb.frozen_stages != 3
                               or not hb.frozen_parameters()):
            raise SystemExit("the published config's frozen_stages=3 is "
                             "not honoured")
        calibrate_bn(model, first_example(ds, cap, ishape, DEV))
        work = os.path.join(tmp, "work")
        save_checkpoint(work, TrainState(0, model, None, None), epoch=1)
        del model, hb
        torch.cuda.empty_cache()

        ws = wrappers()
        for w in ws.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            out = tool.main([cfg_path, "--checkpoint", work, "--work_dir",
                             work, "--speed_test", "--device", DEV, *args])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in ws.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        nscan = len(out["detections"])
        per_scan = {k: n / max(nscan, 1) for k, n in launches.items()}
        log(f"  launches over {nscan} scans: {launches}; per scan "
            f"{per_scan}")
        # per frame: the MSeg3D / SegNet paths' stage tables are (keys,
        # keys, rank, rank), as on semnusc
        want = {k: nscan * c for k, c in e.get(
            "per_frame", KEYS_KEYS_RANK_RANK).items()}
        if nscan != nframes or launches != want:
            raise SystemExit(f"phase {phase}: {nscan} scans, launches "
                             f"{launches}, expected {want}")

        # predictions cover every point of each label file, in range, and
        # spread over the classes
        for token, pred in out["detections"].items():
            labels = pred["pred_point_sem_labels"]
            n = len(ds.get_anno_for_eval(token)["point_sem_labels"])
            if waymo:  # every point predicted, the TOP lidar's labelled
                n_seg, n = n, waymo_frame_points(ds, token)
                if n_seg >= n:
                    raise SystemExit(f"{token}: {n_seg} labelled points "
                                     f"of {n}")
            if labels.shape != (n,) or labels.min() < 0 \
                    or labels.max() >= e["ncls"]:
                raise SystemExit(f"{token}: {labels.shape} labels in "
                                 f"[{labels.min()}, {labels.max()}] for {n} "
                                 "points")
        classes = predicted_classes(out["detections"], e["ncls"],
                                    "published config on the card")
        miou = out["results"]["results"]["mIoU"]
        if not (np.isfinite(miou) and 0.0 < miou <= 100.0):
            raise SystemExit(f"phase {phase}: mIoU {miou}")
        # speed_test's seconds are per batch row; a frame is `rows` rows
        lat = np.asarray(out["latencies"]) * 1e3 * rows
        mid = lat[len(lat) // 3: 2 * len(lat) // 3]
        warm = lat[1:]
        log(f"  per-{'frame (' + str(rows) + ' TTA rows)' if tta else 'scan'}"
            f" ms (speed_test, CUDA events between two "
            f"synchronizations): {[round(float(v), 2) for v in lat]}; "
            f"after the first scan ({len(warm)}): mean {warm.mean():.2f}, "
            f"p50 {np.percentile(warm, 50):.2f}, min {warm.min():.2f}, max "
            f"{warm.max():.2f}; middle third ({len(mid)}) mean "
            f"{mid.mean():.2f}, p50 {np.percentile(mid, 50):.2f}; peak "
            f"memory {peak:.2f} GiB; mIoU {miou:.4f}")

        # the stage tables of one scan: kinds, cells, bytes
        state = out["state"]
        model = state.model
        ex0 = first_example(dataset_in(cfg, "val", tmp, tta), cap, ishape,
                            DEV)
        with torch.inference_mode():
            _, books = lidar_books(model, ex0)
        tables = []
        for i, t in enumerate(stage_tables(books or {}), start=1):
            if isinstance(t, co.KeyTable):
                tables.append(f"s{i} keys")
            else:
                mib = t.packed.shape[-1] * 4 / 2**20
                tables.append(f"s{i} rank {t.packed.shape[-1]} cells "
                              f"{mib:.2f} MiB")
                if mib > 12:
                    raise SystemExit(f"stage {i}: a RankTable above 12 MiB")
        kinds = tuple(t.split()[1] for t in tables) or None
        if kinds != e.get("tables", ("keys", "keys", "rank", "rank")):
            raise SystemExit(f"phase {phase}: stage tables {tables}")
        del books
        log(f"  stage tables of scan 0: {', '.join(tables) or 'none (BEV)'}"
            "; no RankTable above 12 MiB, so no lookup took the JAX "
            "package's _lookup_gather_hbm route (0 launches)")

        # the device histogram against the host one of the predictions
        # (of the frames alone: no TTA merge on the device)
        if not tta:
            with SegDataLoader(ds, 1, cap["max_voxels"], cap["max_points"],
                               shuffle=False, drop_last=False,
                               num_workers=2) as loader:
                _, _, hist = ev.run_eval_device_hist(model, state, loader,
                                                     ishape, ds, e["ncls"])
            # (a Waymo frame's labels, its TOP lidar's, padded with the
            # ignored 0 to its points, as the device side pads them)
            def padded_gt(t, n):
                gt = ds.get_anno_for_eval(t)["point_sem_labels"]
                return np.pad(gt, (0, n - len(gt)))

            want = sum(fast_hist(p["pred_point_sem_labels"], padded_gt(
                t, len(p["pred_point_sem_labels"])), e["ncls"])
                       for t, p in out["detections"].items())
            if not np.array_equal(hist, want):
                raise SystemExit("run_eval_device_hist's histogram differs "
                                 "from the host histogram of the predictions "
                                 f"at {int((hist != want).sum())} entries")
            log(f"  run_eval_device_hist: [{e['ncls']}, {e['ncls']}] "
                f"histogram of {int(hist.sum())} points equals the host "
                "histogram")

        pipe = host_pipeline_ms(dataset_in(cfg, "val", tmp, tta), cap)
        log("  host pipeline ms per frame (one thread): " + ", ".join(
            f"{k} {v:.2f}" for k, v in pipe.items()))
        jpeg = jpeg_read_ms(ds) if (nusc or waymo) and e.get(
            "cams", True) else None
        if jpeg:
            log(f"  read_jpeg_bgr of one {jpeg['hw'][1]}x{jpeg['hw'][0]} "
                f"camera ({jpeg['bytes']} "
                f"bytes): {jpeg['image_ms']:.2f} ms, of which the Huffman "
                f"decoding (C) {jpeg['huffman_ms']:.2f} ms")
        frame0 = (published_frame_on_cpu(e, cfg_path, cfg, tmp, work,
                                         out["detections"], phase, args)
                  if e.get("cpu_frame", True) else None)
        agreement = eval_card_vs_cpu(tmp) if e.get("mini") else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(p50_ms=float(np.percentile(warm, 50)),
                  mean_ms=float(warm.mean()), scans_timed=len(warm),
                  rows_per_frame=rows,
                  speed_test_middle_third_ms=dict(
                      mean=float(mid.mean()),
                      p50=float(np.percentile(mid, 50))),
                  peak_memory_gib=peak, miou=miou,
                  predicted_classes=[int(c) for c in classes],
                  launches_per_scan=per_scan, host_pipeline_ms=pipe,
                  jpeg_read_ms=jpeg, tables=tables,
                  frame0_card_vs_cpu=frame0, card_vs_cpu=agreement)
    return dict(result=result, launches=launches, model=model, ex0=ex0,
                path=dict(V=cap["max_voxels"], N=cap["max_points"]))


def state_equals_checkpoint(state, path):
    """Whether the train state holds exactly what the checkpoint file at
    ``path`` does: every parameter and buffer, the Adam count, mu and nu,
    the step and the dropout generator. -> list of what differs."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    bad = [k for k, v in state.model.state_dict().items()
           if not torch.equal(v.cpu(), ckpt["model"][k])]
    opt = state.opt_state
    if opt.count != ckpt["optimizer"]["count"]:
        bad.append("adam count")
    bad += [f"adam {n}[{i}]" for n in ("mu", "nu")
            for i, (a, b) in enumerate(zip(getattr(opt, n),
                                           ckpt["optimizer"][n], strict=True))
            if not torch.equal(a.cpu(), b)]
    if state.step != ckpt["step"]:
        bad.append("step")
    if not torch.equal(state.generator.get_state(), ckpt["generator"]):
        bad.append("generator")
    return bad


def train_entry_hook(ws, per_step, record, phase, zero_grad_ok=False):
    """A TrainerHook that, after every step, holds each kernel's launches
    since the last step to ``per_step`` and the step's loss terms to
    finite values (kept in record["losses"]), snapshots the parameters at
    the start, and checks at the end that every parameter outside the
    frozen stages moved (their count in record["moved"]). With
    ``zero_grad_ok`` a parameter whose gradient was exactly zero at every
    step may stay (record["zero_grad"]): CenterPoint's L1 regression gives
    a head's output bias the sum of its objects' signs, which cancels
    exactly over an even count, and Adam with decoupled decay leaves a
    zero bias at zero."""
    import math

    import torch
    from lidarseg3d_torch.apis.train import TrainerHook

    class Hook(TrainerHook):
        def before_run(self, state, loop):
            self.last = {k: w.launches for k, w in ws.items()}
            frozen = set(state.model.frozen_parameters())
            self.before = {k: p.detach().clone() for k, p in
                           state.model.named_parameters() if k not in frozen}

        def after_iter(self, state, ldict, global_step):
            vals = {k: float(v) for k, v in ldict.items()}
            bad = [k for k, v in vals.items() if not math.isfinite(v)]
            if bad or "grad_norm" not in vals:
                raise SystemExit(f"phase {phase} step {global_step}: "
                                 f"non-finite or missing loss terms {bad}: "
                                 f"{vals}")
            now = {k: w.launches for k, w in ws.items()}
            delta = {k: now[k] - self.last[k] for k in ws}
            self.last = now
            if delta != per_step:
                raise SystemExit(f"phase {phase} step {global_step}: "
                                 f"launches {delta}, expected {per_step}")
            record.setdefault("losses", []).append((global_step, vals))
            if zero_grad_ok:
                self.graded = getattr(self, "graded", set()) | {
                    k for k, p in state.model.named_parameters()
                    if p.grad is not None and bool(p.grad.ne(0).any())}

        def after_run(self, state):
            params = dict(state.model.named_parameters())
            still = [k for k, p in self.before.items()
                     if torch.equal(p, params[k])
                     or not torch.isfinite(params[k]).all()]
            if zero_grad_ok:
                record["zero_grad"] = [k for k in still
                                       if k not in self.graded
                                       and torch.isfinite(params[k]).all()]
                still = [k for k in still if k not in record["zero_grad"]]
            if still:
                raise SystemExit(f"phase {phase}: {len(still)} parameters "
                                 "outside the frozen stages did not move or "
                                 f"are not finite: {still[:5]}")
            record["moved"] = len(self.before)

    return Hook()


def loader_alone_ms(ds, cfg, B, modes):
    """The loader alone, the config's worker count, no step competing:
    per mode, ms a batch over epoch 0 (its start included: the shm mode
    spawns its workers and builds one batch in-process for the slot
    layout) and over epoch 1 (the workers already up)."""
    from lidarseg3d_torch.datasets import SegDataLoader

    cap = caps(cfg)
    n = cfg.data.get("workers_per_gpu", 4)
    out = {}
    for mode in modes:
        with SegDataLoader(ds, B, cap["max_voxels"], cap["max_points"],
                           seed=7, num_workers=n, worker_mode=mode,
                           on_overflow="error") as loader:
            res = []
            for epoch in (0, 1):
                t0 = time.perf_counter()
                nb = len(list(loader.epoch(epoch)))
                res.append((time.perf_counter() - t0) * 1e3 / nb)
        out[mode] = dict(workers=n, batches=nb, epoch0_ms=res[0],
                         epoch1_ms=res[1])
        log(f"  the loader alone ({mode}, {n} workers): {nb} batches of {B} "
            f"frames an epoch, {res[0]:.2f} ms a batch over epoch 0 (its "
            f"start included), {res[1]:.2f} over epoch 1")
    return out


def write_pretrained_hrnet(tmp, img_bb):
    """A seeded HRNet-w18 in mmcv's names and layout (every key and shape
    of tests/data/hrnetv2_w18_manifest.json, the real checkpoint's),
    saved with torch.save and converted by the port's
    tools/convert_hrnet_checkpoint.py to the config's ``pretrained`` path
    under ``tmp`` (where the train tool runs). -> {"mmcv": the tensors,
    "seconds": of the conversion, "path"}."""
    import numpy as np
    import torch
    from lidarseg3d_torch.tools import convert_hrnet_checkpoint as conv

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "data",
                           "hrnetv2_w18_manifest.json")) as f:
        entries = json.load(f)["entries"]
    rng = np.random.default_rng(17)
    sd = {}
    for key, shape in entries:
        if key.endswith("running_var") or (key.endswith("weight")
                                           and len(shape) == 1):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 4:
            fan = shape[1] * shape[2] * shape[3]
            v = rng.uniform(-1, 1, shape) * np.sqrt(3.0 / fan)
        else:
            v = rng.normal(0.0, 0.1, shape)
        sd[key] = torch.from_numpy(v.astype(np.float32))
    pth = os.path.join(tmp, "hrnetv2_w18_mmcv.pth")
    torch.save({"state_dict": sd}, pth)
    out = os.path.join(tmp, img_bb["pretrained"])
    t0 = time.perf_counter()
    conv.main([pth, out, "--width", "18"])
    return dict(mmcv=sd, seconds=time.perf_counter() - t0, path=out,
                layout=conv.mmcv_layout(conv.HRNET_EXTRA[18]))


def hrnet_grab():
    """A TrainerHook that keeps the image backbone's state_dict as the run
    starts (after the train tool's pretrained import)."""
    from lidarseg3d_torch.apis.train import TrainerHook

    class Grab(TrainerHook):
        state = None

        def before_run(self, state, loop):
            hb = getattr(state.model, "img_backbone_mod", None)
            if hb is not None:
                self.state = {k: v.detach().cpu().clone()
                              for k, v in hb.state_dict().items()}

    return Grab()


def check_pretrained_import(hrnet, got, work, phase):
    """The HRNet the run started from equals the seeded mmcv one bit for
    bit, tensor by tensor by name (the stride-2 fuse convs included), and
    the train log reports every tensor loaded and none skipped."""
    from lidarseg3d_torch.convert import state_dict_to_flax
    from lidarseg3d_torch.models.img_backbones.hrnet import HRNet
    from lidarseg3d_torch.tools import convert_hrnet_checkpoint as conv
    import torch

    bad = []
    for key, v in hrnet["mmcv"].items():
        prefix, _, leaf = key.rpartition(".")
        path, m = hrnet["layout"][prefix]
        parts = list(path)
        if m is not None:
            parts[parts.index("scan") + 1] = str(m)
        name = ".".join(parts) + "." + leaf
        if name not in got or not torch.equal(got[name], v):
            bad.append(key)
    with torch.device("meta"):
        n = sum(a.size > 0 for a in _leaves(state_dict_to_flax(
            HRNet(extra=conv.HRNET_EXTRA[18]))))
    with open(os.path.join(work, "train.log")) as f:
        log_text = f.read()
    want = f"pretrain report: loaded {n}, skipped 0, unexpected 0"
    if bad or len(hrnet["mmcv"]) != len(got) or want not in log_text:
        raise SystemExit(f"phase {phase}: the pretrained HRNet import: "
                         f"{len(bad)} tensors differ ({bad[:3]}), "
                         f"{len(got)} model tensors for "
                         f"{len(hrnet['mmcv'])}; log has '{want}': "
                         f"{want in log_text}")
    hrnet["report"] = dict(loaded=n, skipped=0, unexpected=0,
                           tensors=len(got))
    log(f"  pretrained import: the run started from the seeded HRNet-w18 "
        f"bit for bit ({len(got)} tensors by name, the 47 stride-2 fuse "
        f"convs included); train.log: '{want}'")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def final_state(cfg_path, work, latest):
    """The train state of the run's last checkpoint (phases 4 and 5 read
    its model where no resume ran)."""
    from lidarseg3d_torch.apis.train import (create_train_state,
                                             load_checkpoint)
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer
    from lidarseg3d_torch.utils.config import Config

    cfg = Config.fromfile(cfg_path)
    opt, _ = build_one_cycle_optimizer(dict(cfg.optimizer),
                                       dict(cfg.lr_config), 1)
    state = create_train_state(
        build_detector(cfg.model.to_dict(), device=DEV), opt)
    load_checkpoint(work, state, int(latest.split("_")[1]))
    return state


def run_train_entry(t=TRAIN_ENTRY, e=EVAL, phase="3e"):
    """Phases 3e / 3g: a published config trained through the entry point
    (lidarseg3d_torch.tools.train main, in-process, B = samples_per_gpu)
    on a seeded tree (SemanticKITTI: one frame in each train sequence;
    nuScenes: key frames of train scenes with the infos of
    tools.create_data): --total_epochs E --max_steps_per_epoch S, then
    --resume_from --total_epochs E+1, with the checks of
    train_entry_hook and of the resumed state; the step time, the loader's
    wait, the train pipeline's time per stage, the loader alone and the
    peak memory. Returns the run for phases 4 and 5."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.datasets import SegDataLoader, default_worker_mode
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer
    from lidarseg3d_torch.synthetic import (write_eval_config,
                                            write_semantickitti_tree)
    from lidarseg3d_torch.tools import test as eval_tool
    from lidarseg3d_torch.tools import train as tool
    from lidarseg3d_torch.utils.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    nusc, waymo = "scenes" in t, bool(t.get("waymo"))
    tmp = tempfile.mkdtemp(prefix=f"train_{phase}_")
    try:
        base = Config.fromfile(os.path.join(here, e["config"]))
        if waymo:
            cfg_path = os.path.join(here, e["config"])
            if t.get("loader"):
                cfg_path = with_loader(cfg_path, os.path.join(tmp, "cfg.py"),
                                       t["loader"])
            secs = link_waymo_tree(tmp, base)
            what = waymo_tree_text("training")
        elif nusc:
            cfg_path = os.path.join(here, e["config"])
            if t.get("loader"):
                cfg_path = with_loader(cfg_path, os.path.join(tmp, "cfg.py"),
                                       t["loader"])
            secs = write_nusc_tree(tmp, base, t)
            what = (f"train scenes {list(t['scenes'])}, {t['samples']} key "
                    f"frames each of {t['points'][0]}-{t['points'][1]} "
                    "points and " + ("six 1600x900 JPEGs" if t.get(
                        "cams", True) else "no camera"))
        else:
            seqs = list(base.train_seq)
            data_root = os.path.join(tmp, "sequences")
            t0 = time.perf_counter()
            write_semantickitti_tree(data_root, seqs, frames=t["frames"],
                                     points=t["points"], seed=t["seed"],
                                     image_hw=t["image_hw"],
                                     max_range=t["max_range"])
            secs = time.perf_counter() - t0
            cfg_path = write_eval_config(os.path.join(tmp, "train.py"),
                                         os.path.join(here, e["config"]),
                                         data_root)
            if t.get("loader"):
                cfg_path = with_loader(cfg_path, os.path.join(
                    tmp, "train_loader.py"), t["loader"])
            H, W = t["image_hw"]
            what = (f"sequences {seqs}, {t['frames']} frame each of "
                    f"{t['points'][0]}-{t['points'][1]} points and {W}x{H} "
                    "PNGs")
        cfg = Config.fromfile(cfg_path)
        cap, ishape = caps(cfg), eval_tool.input_shape_of(cfg)
        B = t.get("batch_size") or cfg.data.samples_per_gpu
        mode = default_worker_mode(cfg.data)
        img_bb = cfg.model.get("img_backbone")
        hrnet = None
        if img_bb and t.get("pretrained_import"):
            hrnet = write_pretrained_hrnet(tmp, img_bb)
        log(f"  tree: {what} written in {secs:.2f} s; B={B}, grid {ishape}, "
            f"capacity {dict(cap)}, loader {mode} "
            f"x{cfg.data.workers_per_gpu}, pretrained "
            + ("none (no image backbone)" if not img_bb
               else f"{img_bb.get('pretrained')} (missing: not loaded)"
               if hrnet is None else f"{img_bb.get('pretrained')}, "
               f"converted from a seeded mmcv HRNet-w18 state_dict "
               f"({len(hrnet['mmcv'])} tensors) by the port's converter in "
               f"{hrnet['seconds']:.2f} s"))
        if (nusc or waymo) and mode != t.get("loader", "shm"):
            raise SystemExit(f"phase {phase}: the loader would run in "
                             f"{mode} mode, not shm ({os.cpu_count()} CPUs)")
        work = os.path.join(tmp, "work")
        args = [cfg_path, "--work_dir", work, "--max_steps_per_epoch",
                str(t["steps"]), "--device", DEV, "--batch_size", str(B)]

        ws = wrappers()
        record, timings = {}, []
        for w in ws.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        cwd = os.getcwd()
        os.chdir(tmp)  # the config's relative paths (pretrained: missing)
        try:
            grab = hrnet_grab()
            tool.main(args + ["--total_epochs", str(t["epochs"])],
                      hooks=[grab, train_entry_hook(ws, t["per_step"],
                                                    record, phase)],
                      timings=timings)
            if hrnet is not None:
                check_pretrained_import(hrnet, grab.state, work, phase)
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in ws.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            nsteps = t["epochs"] * t["steps"]
            files = sorted(os.listdir(work))
            want_files = [f"epoch_{i + 1}" for i in range(t["epochs"])] + [
                "latest.txt", "train.log"]
            if files != want_files or len(timings) != nsteps:
                raise SystemExit(f"phase {phase}: {files} after "
                                 f"{len(timings)} steps, expected "
                                 f"{want_files} after {nsteps}")
            with open(os.path.join(work, "latest.txt")) as f:
                latest = f.read().strip()
            if latest != f"epoch_{t['epochs']}":
                raise SystemExit(f"phase {phase}: latest.txt names {latest}")
            want = {k: nsteps * c for k, c in t["per_step"].items()}
            if launches != want:
                raise SystemExit(f"phase {phase}: launches {launches}, "
                                 f"expected {want}")
            log(f"  {nsteps} steps over {t['epochs']} epochs: launches "
                f"{launches} (per step {t['per_step']}); "
                f"{record['moved']} parameters outside the frozen stages "
                f"all moved; wrote {files}")
            for step, vals in record["losses"]:
                log(f"  step {step}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in vals.items()))

            # the resume: the state it loads equals the saved one exactly
            class Check(tr.TrainerHook):
                def before_run(self, state, loop):
                    self.diff = state_equals_checkpoint(
                        state, os.path.join(work, latest))
                    self.start = (int(state.step),
                                  int(state.opt_state.count))

                def after_iter(self, state, ldict, global_step):
                    self.first = getattr(self, "first", global_step)

            check = Check()
            out = None
            if t.get("resume", True):
                # the resume's subject is the state it loads: its loader
                # runs threads (the first run drove the config's mode)
                rcfg = cfg_path if mode == "thread" else with_loader(
                    cfg_path, os.path.join(tmp, "resume.py"), "thread")
                out = tool.main([rcfg] + args[1:] + [
                    "--resume_from", "--total_epochs", str(t["epochs"] + 1)],
                    hooks=[check, train_entry_hook(ws, t["per_step"], record,
                                                   phase)])
        finally:
            os.chdir(cwd)
        if out is None:
            log("  no resume on this path")
            out = dict(state=final_state(cfg_path, work, latest))
        elif check.diff or check.start != (nsteps, nsteps) \
                or check.first != nsteps:
            raise SystemExit(f"phase {phase} resume: differs from {latest} "
                             f"in {check.diff[:5]}; starts at {check.start}, "
                             f"first step {check.first}, expected {nsteps}")
        else:
            log(f"  resume: the state loaded from {latest} equals the saved "
                f"one exactly (every parameter and buffer, Adam count / mu "
                f"/ nu, step, generator); it started at global step "
                f"{check.first} and ran {t['steps']} more steps")

        steps = np.asarray([x["step_s"] for x in timings[1:]]) * 1e3
        waits = np.asarray([x["data_s"] for x in timings]) * 1e3
        log(f"  per-step ms (host clock to a synchronisation, B={B}): "
            f"{[round(x['step_s'] * 1e3, 2) for x in timings]}; after the "
            f"first: p50 {np.percentile(steps, 50):.2f}, mean "
            f"{steps.mean():.2f}; loader wait per step ms "
            f"{[round(float(v), 2) for v in waits]} (p50 "
            f"{np.percentile(waits, 50):.2f}, after the first "
            f"{waits[1:].mean():.2f} mean); peak memory {peak:.2f} GiB")

        # the stage tables of the first batch, and the example of phase 4
        state = out["state"]
        model = state.model
        ds = dataset_in(cfg, "train", tmp)
        with SegDataLoader(ds, B, cap["max_voxels"], cap["max_points"],
                           shuffle=False, num_workers=B,
                           on_overflow="error") as loader:
            ex0 = tr.example_to_device(next(loader.epoch(0)), DEV)
        ex0["input_shape"] = ishape
        with torch.inference_mode():
            _, books = lidar_books(model, ex0)
        tabs = stage_tables(books or {})
        kinds = tuple("keys" if isinstance(tb, co.KeyTable) else "rank"
                      for tb in tabs) or None
        nv = [books[f"s{i}"].num_voxels.tolist()
              for i in range(1, len(tabs) + 1)]
        del books, tabs
        log(f"  stage tables {kinds}; voxels of the first batch by stage "
            f"{nv}")
        if kinds != t.get("tables", ("keys", "keys", "rank", "rank")):
            raise SystemExit(f"phase {phase}: table kinds {kinds}")
        pipe = host_pipeline_ms(ds, cap)
        log("  train pipeline ms per frame (one thread): " + ", ".join(
            f"{k} {v:.2f}" for k, v in pipe.items()))
        alone = loader_alone_ms(ds, cfg, B, t.get("loader_modes",
                                                  ("thread",)))
        opt, _ = build_one_cycle_optimizer(
            dict(cfg.optimizer), dict(cfg.lr_config),
            (t["epochs"] + 1) * t["steps"],
            grad_clip=cfg.optimizer_config.grad_clip.max_norm)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(p50_ms=float(np.percentile(steps, 50)),
                  mean_ms=float(steps.mean()), steps_timed=len(steps),
                  batch_size=B, pretrained_import=None if hrnet is None
                  else hrnet["report"],
                  step_ms=[x["step_s"] * 1e3 for x in timings],
                  data_wait_ms=waits.tolist(),
                  data_wait_p50_ms=float(np.percentile(waits, 50)),
                  loader_mode=mode, peak_memory_gib=peak,
                  launches_per_step=t["per_step"], tables=list(kinds or ()),
                  voxels_first_batch=nv, host_pipeline_ms=pipe,
                  loader_alone=alone, last_losses=record["losses"][-1][1])
    return dict(result=result, launches=launches, model=model, ex0=ex0,
                state=state, step=tr.make_train_step(model, opt, ishape),
                path=dict(V=cap["max_voxels"], N=cap["max_points"]))


def ddp_rows(batch, world):
    """Rank r's rows of a collated batch (B = world * b rows): every key's
    slice on the batch axis; images_sem_labels has ncam rows a frame."""
    B = len(batch["num_voxels"])
    b = B // world
    out = []
    for r in range(world):
        part = {}
        for k, v in batch.items():
            per = v.shape[0] // B if k == "images_sem_labels" else 1
            part[k] = v[r * b * per:(r + 1) * b * per]
        out.append(part)
    return out


def ddp_record(model, ldict):
    """A train step's loss terms, gradients and state, on the host."""
    return dict(losses={k: float(v) for k, v in ldict.items()},
                grads={k: p.grad.detach().to("cpu", copy=True) for k, p in
                       model.named_parameters() if p.grad is not None},
                state={k: v.detach().to("cpu", copy=True) for k, v in
                       model.state_dict().items()})


def ddp_digest(model):
    """sha1 of every state_dict tensor's bytes: equal digests are
    bit-identical tensors."""
    import hashlib

    import torch

    return {k: hashlib.sha1(v.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def ddp_step_model(job):
    """The 3c model from the phase's first state on the job's device, its
    train state and step (phase 3n)."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector

    t = job["train"]
    model = build_detector(syn.mseg3d_model_cfg(**t["cfg"]),
                           device=job["device"], seed=0)
    model.load_state_dict(torch.load(job["state"], map_location=job["device"],
                                     weights_only=True))
    return (model, *train_setup(model, t["optimizer"], t["lr"],
                                t["total_steps"], t["grad_clip"],
                                syn.grid_shape())[1:])


def ddp_rank_step(rank, job):
    """Phase 3n (a) on one rank: the first step of the 3c model on this
    rank's row (counted launches, the record), then timed steps, each
    between two barriers; the state's digest after each."""
    import numpy as np
    import torch
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.parallel import dist

    dev = job["device"]
    ex = tr.example_to_device(dict(np.load(job["rows"][rank])), dev)
    model, state, step = ddp_step_model(job)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    import torch.distributed as tdist

    real, calls = tdist.all_reduce, []  # count the step's all-reduces

    def counted(*a, **k):
        calls.append(a[0].numel())
        return real(*a, **k)

    tdist.all_reduce = counted
    try:
        state, ldict = step(state, ex)
    finally:
        tdist.all_reduce = real
    sync()
    out = dict(launches={k: w.launches for k, w in ws.items()},
               all_reduces=len(calls), all_reduce_numel=sum(calls),
               record=ddp_record(model, ldict) if rank == 0 else None,
               first=ddp_digest(model))
    times = []
    for _ in range(job["timed_steps"]):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        check_losses(step(state, ex)[1], f"rank {rank} step")
        sync()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    out.update(times=times, last=ddp_digest(model), peak_gib=(
        torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else 0.0))
    return out


def ddp_rank_train(rank, job):
    """Phase 3n (c) on one rank: tools.train on the published config
    (--dist_* flags, card 0 shared), one epoch of ``train_steps`` steps,
    then a resume for a second; each step's launches held to TRAIN_ENTRY's, every
    parameter outside the frozen stages moved, the resumed state equal to
    the checkpoint. -> files, launches, losses, digests."""
    from lidarseg3d_torch.apis.train import TrainerHook
    from lidarseg3d_torch.tools import train as tool

    per_step = job["train_entry_per_step"]
    work = os.path.join(job["train_dir"], "work")
    base = [job["train_cfg"], "--work_dir", work, "--max_steps_per_epoch",
            str(job["train_steps"]), "--device", job["device"],
            "--dist_share_card",
            "--dist_num_processes", "2", "--dist_process_id", str(rank)]
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    record, grab = {}, {}

    class Keep(TrainerHook):
        def before_run(self, state, loop):
            if "diff" not in grab and state.step > 0:
                grab["diff"] = state_equals_checkpoint(
                    state, os.path.join(work, "epoch_1"))
                grab["start"] = int(state.step)

        def after_run(self, state):
            grab["digest"] = ddp_digest(state.model)

    cwd = os.getcwd()
    os.chdir(job["train_dir"])
    try:
        tool.main(base + ["--total_epochs", "1", "--dist_coordinator",
                          f"file://{job['tmp']}/rv_train1"],
                  hooks=[train_entry_hook(ws, per_step, record, "3n"),
                         Keep()])
        files = sorted(os.listdir(work))
        first = {k: w.launches for k, w in ws.items()}
        tool.main(base + ["--total_epochs", "2", "--resume_from",
                          "--dist_coordinator",
                          f"file://{job['tmp']}/rv_train2"],
                  hooks=[Keep(), train_entry_hook(ws, per_step, record,
                                                  "3n")])
    finally:
        os.chdir(cwd)
    return dict(files=files, launches_first=first,
                launches={k: w.launches for k, w in ws.items()},
                losses=record["losses"], moved=record["moved"],
                resume_diff=grab["diff"], resume_start=grab["start"],
                digest=grab["digest"])


def ddp_rank_eval(rank, job):
    """Phase 3n (d) on one rank: tools.test over the odd tree (--dist_*
    flags, card 0 shared). -> its detections, result and launches."""
    from lidarseg3d_torch.tools import test as tool

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    cwd = os.getcwd()
    os.chdir(job["eval_dir"])
    try:
        out = tool.main(job["eval_args"] + [
            "--dist_share_card", "--dist_coordinator",
            f"file://{job['tmp']}/rv_eval", "--dist_num_processes", "2",
            "--dist_process_id", str(rank)])
    finally:
        os.chdir(cwd)
    return dict(detections=out["detections"], results=out["results"],
                launches={k: w.launches for k, w in ws.items()})


def ddp_rank(rank, job):
    """One of phase 3n's two ranks (a spawned process; both on card 0,
    joined over gloo): (a), then (c), then (d). Its result, or its
    traceback, goes to a file the phase reads."""
    import traceback

    import torch

    out = os.path.join(job["tmp"], f"rank{rank}.pt")
    try:
        from lidarseg3d_torch.parallel import dist

        # two ranks on the host's cores: intra-op threads that spin in one
        # rank's host ops starve the other's
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
        dist.init_distributed(f"file://{job['tmp']}/rv_step", 2, rank,
                              device=job["device"], share_card=True)
        try:
            res = {"step": ddp_rank_step(rank, job)}
        finally:
            dist.shutdown()
        res["train"] = ddp_rank_train(rank, job)
        res["eval"] = ddp_rank_eval(rank, job)
        torch.save({"result": res}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def ddp_nccl_one_rank(job):
    """Phase 3n (b) (a spawned process): torchrun's variables for one rank,
    deterministic algorithms; the 3c step on the whole B=2 batch twice
    without a process group, then once in the one-rank NCCL group
    init_distributed starts from the variables. -> per tensor, whether
    the group's step equals the first exactly, and the spreads."""
    import traceback

    out = os.path.join(job["tmp"], "nccl.pt")
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(job["port"]),
                      CUBLAS_WORKSPACE_CONFIG=":4096:8")
    import numpy as np
    import torch
    import torch.distributed as tdist

    try:
        from lidarseg3d_torch.apis import train as tr
        from lidarseg3d_torch.parallel import dist

        torch.use_deterministic_algorithms(True, warn_only=True)
        ex = tr.example_to_device(dict(np.load(job["batch"])), job["device"])
        backend = "nccl" if job["device"] == "cuda" else "gloo"
        recs = []
        for i in range(3):
            if i == 2:
                got = dist.init_distributed(device=job["device"])
                if got != (0, 1) or tdist.get_backend() != backend:
                    raise SystemExit(f"torchrun variables started {got} on "
                                     f"{tdist.get_backend()}")
            model, state, step = ddp_step_model(job)
            state, ldict = step(state, ex)
            recs.append(ddp_record(model, ldict))
            del model, state, step
        dist.shutdown()
        a1, a2, b = recs
        rows = {}
        for part in ("grads", "state"):
            for k, v in a1[part].items():
                rows[f"{part}:{k}"] = (
                    bool(torch.equal(b[part][k], v)),
                    float((b[part][k].double() - v.double()).abs().max()),
                    float((a2[part][k].double() - v.double()).abs().max()))
        losses = {k: (v, a2["losses"][k], b["losses"][k])
                  for k, v in a1["losses"].items()}
        torch.save({"result": dict(rows=rows, losses=losses)}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def ddp_spawn(target, args_list, tmp, names, timeout):
    """Start one spawned process per argument tuple, wait for all, and read
    each one's result file (a failure's traceback ends the phase)."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    t_end = time.perf_counter() + timeout
    for p in procs:
        p.join(max(t_end - time.perf_counter(), 1))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
    results = []
    for name, p in zip(names, procs):
        path = os.path.join(tmp, name)
        got = (torch.load(path, weights_only=False) if os.path.exists(path)
               else {"error": f"no result, exit code {p.exitcode}"})
        if "error" in got:
            raise SystemExit(f"phase 3n: {name} failed:\n{got['error']}")
        results.append(got["result"])
    return results


def same_results(a, b):
    """Two evaluation result dicts equal, NaN (a class absent) as NaN."""
    import math

    return a.keys() == b.keys() and all(
        a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def ddp_compare_step(one, got, errors):
    """Phase 3n (a)'s limits: rank 0's first step against one process's
    on both rows; what breaks one goes to ``errors``. -> the worst
    relative errors, for the log."""
    import torch

    lr = TRAIN["lr"]["lr_max"] / TRAIN["lr"]["div_factor"]
    for k, v in one["losses"].items():
        # the gradient norm differs as the gradients do: by at most their
        # difference's norm, held below in relative L2
        lim = TOL_DDP_GRAD["lidar+head"][0] if k == "grad_norm" \
            else TOL_TRAIN_LOSS
        g = got["losses"][k]
        if abs(g - v) > lim * abs(v):
            errors.append(f"phase 3n: loss term {k} {g} on two ranks, "
                             f"{v} in one process")
    worst = {}
    for k, want in one["grads"].items():
        group = "image" if k.startswith("img_") else "lidar+head"
        l2_lim, max_lim = TOL_DDP_GRAD[group]
        g = got["grads"][k].double()
        w = want.double()
        scale = float(w.abs().max())
        atol = 1e-8 * one["losses"]["grad_norm"]
        err = float((g - w).abs().max())
        l2 = float((g - w).norm() / w.norm()) if scale > 10 * atol else 0.0
        if err > max_lim * scale + atol or l2 > l2_lim:
            errors.append(f"phase 3n: gradient of {k}: {err:.3e} of max "
                             f"{scale:.3e}, relative L2 {l2:.3e} (limits "
                             f"{max_lim}, {l2_lim})")
        d = (got["state"][k].double() - one["state"][k].double()).abs()
        firm = w.abs() >= max(1e-5, max_lim * scale + atol)
        if float(d.max()) > 2 * lr + 1e-7 or (
                firm.any() and float(d[firm].max()) > 1e-2 * lr):
            errors.append(f"phase 3n: parameter {k} after the step off "
                             f"by {float(d.max()):.3e} (lr {lr})")
        if scale > 10 * atol:
            worst[group] = max(worst.get(group, (0.0, 0.0, "")),
                               (l2, err / scale, k))
    for k, v in one["state"].items():
        if k.endswith(("running_mean", "running_var")):
            err = float((got["state"][k].double() - v.double()).abs().max())
            if err > TOL_DDP_STATS * float(v.abs().max()):
                errors.append(f"phase 3n: BN statistic {k} off by {err}")
    return worst


def run_ddp():
    """Phase 3n: multi-process training and evaluation (parallel/): (a)
    the 3c step on two ranks sharing the card over gloo, a row each,
    against one process on both rows; (b) one NCCL rank started from
    torchrun's variables against no process group; (c) tools.train on two
    ranks at the published config (3e's tree and imported HRNet); (d)
    tools.test on two ranks over an odd count of 3d's frames against one
    rank. Returns the run for phase 4's launch counts."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.apis.train import TrainState, save_checkpoint
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.synthetic import (write_eval_config,
                                            write_semantickitti_tree)
    from lidarseg3d_torch.tools import test as eval_tool
    from lidarseg3d_torch.utils.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    t, d = TRAIN, DDP
    tmp = tempfile.mkdtemp(prefix="ddp_3n_")
    try:
        # (a) inputs: 3c's model and a labelled B=2 batch, split in rows
        batch = syn.synthetic_mseg3d_batch(2, t["V"], t["N"],
                                           img_hw=t["img_hw"], seed=d["seed"],
                                           with_labels=True)
        rows = ddp_rows(batch, 2)
        nvalid = [int(r["voxel_valid"].sum()) for r in rows]
        job = dict(tmp=tmp, device=DEV, train=t,
                   train_entry_per_step=TRAIN_ENTRY["per_step"],
                   state=os.path.join(tmp, "state.pt"),
                   batch=os.path.join(tmp, "batch.npz"),
                   rows=[os.path.join(tmp, f"row{r}.npz") for r in (0, 1)],
                   timed_steps=d["timed_steps"], train_steps=d["steps"])
        np.savez(job["batch"], **{k: v for k, v in batch.items()
                                  if isinstance(v, np.ndarray)})
        for r, part in enumerate(rows):
            np.savez(job["rows"][r], **{k: v for k, v in part.items()
                                        if isinstance(v, np.ndarray)})
        model = build_detector(syn.mseg3d_model_cfg(**t["cfg"]), device=DEV,
                               seed=0)
        torch.save(model.state_dict(), job["state"])
        del model
        ex = tr.example_to_device(batch, DEV)
        model, state, step = ddp_step_model(job)
        sync = torch.cuda.synchronize if DEV == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        state, ldict = step(state, ex)
        sync()
        one_ms = (time.perf_counter() - t0) * 1e3
        one = ddp_record(model, ldict)
        with torch.inference_mode():  # eval mode: the running statistics
            model.eval()
            both = model.image_branch(ex)["image_features"]
            alone = torch.cat([model.image_branch(
                {"images": ex["images"][i:i + 1]})["image_features"]
                for i in (0, 1)])
            img_rel = float((both - alone).abs().max() / both.abs().max())
        del model, state, step
        # the same step once more: the card's own run-to-run spread (the
        # gathers' backward adds atomically)
        model, state, step = ddp_step_model(job)
        again = ddp_record(model, step(state, ex)[1])
        one_times = []
        for _ in range(d["timed_steps"]):
            t0 = time.perf_counter()
            check_losses(step(state, ex)[1], "one-process step")
            sync()
            one_times.append((time.perf_counter() - t0) * 1e3)
        del model, state, step, ex
        log(f"  (a) the 3c model's first step on one B=2 batch (valid "
            f"voxels by row {nvalid}) in one process: {one_ms:.2f} ms "
            f"(first call); then {d['timed_steps']} steps of "
            f"{[round(x, 2) for x in one_times]} ms")

        # (c) inputs: 3e's tree, config and imported HRNet
        e, te = EVAL, TRAIN_ENTRY
        job["train_dir"] = os.path.join(tmp, "train")
        os.makedirs(job["train_dir"])
        base = Config.fromfile(os.path.join(here, e["config"]))
        root = os.path.join(job["train_dir"], "sequences")
        write_semantickitti_tree(root, list(base.train_seq),
                                 frames=te["frames"], points=te["points"],
                                 seed=te["seed"], image_hw=te["image_hw"],
                                 max_range=te["max_range"])
        job["train_cfg"] = with_loader(
            write_eval_config(os.path.join(job["train_dir"], "t.py"),
                              os.path.join(here, e["config"]), root),
            os.path.join(job["train_dir"], "train.py"), "thread")
        hrnet = write_pretrained_hrnet(job["train_dir"],
                                       base.model.img_backbone)
        train_B = Config.fromfile(job["train_cfg"]).data.samples_per_gpu

        # (d) inputs: an odd count of 3d's frames and a checkpoint of
        # seeded weights with BN statistics calibrated on frame 0
        job["eval_dir"] = os.path.join(tmp, "eval")
        write_semantickitti_tree(
            os.path.join(job["eval_dir"], base.data_root), ("08",),
            frames=d["eval_frames"], points=e["points"], seed=e["seed"],
            image_hw=e["image_hw"], max_range=e["max_range"])
        ecfg_path = with_loader(os.path.join(here, e["config"]),
                                os.path.join(job["eval_dir"], "eval.py"),
                                "thread")
        ecfg = Config.fromfile(ecfg_path)
        cap, ishape = caps(ecfg), eval_tool.input_shape_of(ecfg)
        model = build_detector(ecfg.model.to_dict(), device=DEV, seed=0)
        calibrate_bn(model, first_example(
            dataset_in(ecfg, "val", job["eval_dir"]), cap, ishape, DEV))
        ework = os.path.join(job["eval_dir"], "work")
        save_checkpoint(ework, TrainState(0, model, None, None), epoch=1)
        del model
        job["eval_args"] = [ecfg_path, "--checkpoint", ework, "--work_dir",
                            ework, "--device", DEV]
        cwd = os.getcwd()
        os.chdir(job["eval_dir"])
        try:
            one_eval = eval_tool.main(job["eval_args"])
        finally:
            os.chdir(cwd)
        if DEV == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = ddp_spawn(ddp_rank, [(r, job) for r in (0, 1)], tmp,
                          ["rank0.pt", "rank1.pt"], d["timeout_s"])
        ranks_s = time.perf_counter() - t0
        with socket.socket() as s:
            s.bind(("localhost", 0))
            job["port"] = s.getsockname()[1]
        t0 = time.perf_counter()
        (nccl,) = ddp_spawn(ddp_nccl_one_rank, [(job,)], tmp, ["nccl.pt"],
                            d["timeout_s"])
        nccl_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (a) the two ranks against one process, and against each other; every
    # check runs, and the phase fails at its end if one did not hold
    errors = []
    a = [r["step"] for r in ranks]
    for r, x in enumerate(a):
        if x["launches"] != t["per_step"]:
            errors.append(f"phase 3n (a): rank {r} launched "
                             f"{x['launches']} in its step, expected "
                             f"{t['per_step']}")
    worst = ddp_compare_step(one, a[0]["record"], errors)
    spread = ddp_compare_step(one, again, [])
    rel = ", ".join(
        f"{k} {abs(a[0]['record']['losses'][k] - v) / max(abs(v), 1e-30):.2e}"
        for k, v in one["losses"].items())
    for when in ("first", "last"):
        diff = [k for k, v in a[0][when].items() if a[1][when][k] != v]
        if diff:
            errors.append(f"phase 3n (a): the ranks' states differ after "
                             f"the {when} step: {diff[:5]}")
    steps = np.asarray([max(x, y) for x, y in zip(a[0]["times"],
                                                  a[1]["times"])])
    p50 = float(np.percentile(steps, 50))
    log(f"  (a) two ranks sharing the card over gloo, B=1 each: launches per "
        f"rank in the step {a[0]['launches']} (3c's per step); loss terms "
        f"within {TOL_TRAIN_LOSS} of one process's (relative: {rel}); "
        f"worst gradient (relative L2, max err / max) by group {worst} "
        f"(limits {TOL_DDP_GRAD}; one process against itself: {spread}; "
        f"the image branch's features in eval mode, each image alone "
        f"against both at once: {img_rel:.3e} of their max); "
        f"BN statistics within {TOL_DDP_STATS}; parameters bit-identical on "
        f"both ranks after the first step and after "
        f"{d['timed_steps']} more")
    log(f"  (a) step of two ranks sharing one card (not a scaling figure): "
        f"{[round(float(x), 2) for x in steps]} ms, p50 {p50:.2f}; one "
        f"process at B=2 on the same card: p50 "
        f"{float(np.percentile(one_times, 50)):.2f} ms; peak memory per rank "
        f"{[round(x['peak_gib'], 2) for x in a]} GiB; all-reduces a step "
        f"{a[0]['all_reduces']} ({a[0]['all_reduce_numel']} elements, the "
        f"gradients' one among them)")

    # (b) one NCCL rank from torchrun's variables against no group
    rows_b = nccl["rows"]
    exact = sum(v[0] for v in rows_b.values())
    loose = {k: v for k, v in rows_b.items() if not v[0]}
    over = {k: v for k, v in loose.items() if v[1] > 4 * v[2]}
    bad_loss = {k: v for k, v in nccl["losses"].items()
                if v[0] == v[1] and v[2] != v[0]}
    if over or bad_loss:
        errors.append(f"phase 3n (b): the one-rank NCCL step differs from "
                         f"the step without a group beyond its own spread: "
                         f"{dict(list(over.items())[:5])} {bad_loss}")
    log(f"  (b) one NCCL rank from torchrun's variables: {exact} of "
        f"{len(rows_b)} gradient and state tensors bit for bit as without a "
        f"process group; {len(loose)} differ, each within 4x the spread of "
        f"two runs without a group (deterministic algorithms on; "
        f"{sum(1 for v in rows_b.values() if v[2] > 0)} tensors vary between "
        f"those two runs); loss terms {nccl['losses']}")

    # (c) tools.train on two ranks
    c = [r["train"] for r in ranks]
    want_files = ["epoch_1", "latest.txt", "train.log"]
    nsteps = 2 * d["steps"]
    want = {k: nsteps * v for k, v in te["per_step"].items()}
    for r, x in enumerate(c):
        if x["launches"] != want:
            errors.append(f"phase 3n (c): rank {r} launched "
                             f"{x['launches']}, expected {want}")
        if x["resume_diff"] or x["resume_start"] != d["steps"]:
            errors.append(f"phase 3n (c): rank {r}'s resume differs from "
                             f"epoch_1 in {x['resume_diff'][:5]} or starts "
                             f"at {x['resume_start']}")
    if c[0]["files"] != want_files:
        errors.append(f"phase 3n (c): the first run wrote {c[0]['files']}"
                         f", expected {want_files}")
    diff = [k for k, v in c[0]["digest"].items() if c[1]["digest"][k] != v]
    if diff:
        errors.append(f"phase 3n (c): the ranks' final states differ: "
                         f"{diff[:5]}")
    log(f"  (c) tools.train on two ranks (the published config, B="
        f"{train_B} a rank, "
        f"HRNet-w18 imported from a converted mmcv file of "
        f"{len(hrnet['mmcv'])} tensors): 1 epoch of {d['steps']} steps wrote "
        f"{c[0]['files']} once; the resume read epoch_1 exactly on both "
        f"ranks and ran {d['steps']} more; launches per rank {c[0]['launches']}"
        f"; {c[0]['moved']} parameters outside the frozen stages moved; "
        f"final states bit-identical on both ranks; losses (global) "
        + "; ".join(f"step {s}: loss {v['loss']:.4f}" for s, v in
                    c[0]["losses"]))

    # (d) tools.test on two ranks against one rank
    dd = [r["eval"] for r in ranks]
    toks = [set(x["detections"]) for x in dd]
    if toks[0] & toks[1] or toks[0] | toks[1] != set(one_eval["detections"]):
        errors.append(f"phase 3n (d): the ranks' frames {toks} do not "
                         f"split {sorted(one_eval['detections'])}")
    for x in dd:
        for tok, det in x["detections"].items():
            if not np.array_equal(det["pred_point_sem_labels"],
                                  one_eval["detections"][tok][
                                      "pred_point_sem_labels"]):
                errors.append(f"phase 3n (d): labels of {tok} differ "
                                 "from the one-rank run's")
        if not same_results(x["results"]["results"],
                            one_eval["results"]["results"]):
            errors.append(f"phase 3n (d): results {x['results']} differ "
                             f"from one rank's {one_eval['results']}")
    per_frame = KEYS_KEYS_RANK_RANK
    for r, x in enumerate(dd):
        want = {k: 2 * v for k, v in per_frame.items()}  # frames a rank
        if x["launches"] != want:
            errors.append(f"phase 3n (d): rank {r} launched "
                             f"{x['launches']}, expected {want}")
    miou = one_eval["results"]["results"]["mIoU"]
    log(f"  (d) tools.test on two ranks over {d['eval_frames']} frames: rank "
        f"0 owns {sorted(toks[0])}, rank 1 {sorted(toks[1])} (its padding "
        f"repeat of frame 0 evaluated, not counted); labels equal the "
        f"one-rank run's on every frame; mIoU {miou:.4f} on both ranks and "
        f"one rank")
    log(f"  spawned ranks: {ranks_s:.1f} s for (a), (c) and (d); the NCCL "
        f"rank {nccl_s:.1f} s")
    if errors:
        raise SystemExit("phase 3n:\n  " + "\n  ".join(errors[:40]))
    launches = {k: sum(r[p]["launches"][k] for r in ranks
                       for p in ("step", "train", "eval"))
                for k in t["per_step"]}
    result = dict(step_two_ranks_ms=steps.tolist(),
                  step_two_ranks_p50_ms=p50,
                  step_one_process_b2_ms=one_times,
                  peak_memory_gib_per_rank=[x["peak_gib"] for x in a],
                  all_reduces_per_step=a[0]["all_reduces"],
                  worst_grad=worst, nccl_exact=exact,
                  nccl_tensors=len(rows_b), eval_miou=miou,
                  train_losses=c[0]["losses"])
    return dict(result=result, launches=launches)


def profile_call(fn, what, top=12, host_top=0):
    """fn() under torch.profiler: the share of its span in which a kernel
    ran on the card, and the kernels that took the most device time (with
    ``host_top``, also the host operations that took the most host time,
    by self time). Returns the busy share (None when the profiler recorded
    no device activity) and {kernel name: (device us, launches)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = activities(prof)
    kern = [(a, b, name) for a, b, name, dev in events if dev]
    if not kern:
        log("  profile: no device activity recorded; busy share not measured")
        return None, {}
    t0 = min(a for a, _, _, _ in events)
    t1 = max(b for _, b, _, _ in events)
    busy, cur_s, cur_e = 0.0, None, None
    per_name = {}
    for s, e, name in sorted(kern):
        tot, cnt = per_name.get(name, (0.0, 0))
        per_name[name] = (tot + (e - s), cnt + 1)
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    share = busy / (t1 - t0)
    log(f"  profile of one {what}: span {(t1 - t0) / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * share:.1f}%), {len(kern)} device "
        f"activities")
    for name, (tot, cnt) in sorted(per_name.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
        log(f"    {tot / 1e3:8.3f} ms {100 * tot / busy:5.1f}% x{cnt:<5d} "
            f"{name[:90]}")
    if host_top:
        ops = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CPU]
        log(f"  host operations by self time ({len(ops)} kinds):")
        for a in sorted(ops, key=lambda a: -a.self_cpu_time_total)[:host_top]:
            log(f"    {a.self_cpu_time_total / 1e3:8.3f} ms x{a.count:<5d} "
                f"{a.key[:90]}")
    return share, per_name


# device kernels of one structures+rulebooks build before the fused
# rulebook kernels, when a rulebook was ~90 small operations around one
# gather (phase 5's profile on an H100 at 700 W; PERF.md)
BUILD_KERNELS_BEFORE = {"semkitti": 855, "semnusc": 889, "eval": 890}


def profile_structures(name, r):
    """Phase 5: the structures+rulebooks part of one scan of an inference
    path (the split's third span: stage structures, lookup tables and the
    10 rulebooks) under the profiler, after a warm call."""
    import torch

    model = r["model"]
    with torch.inference_mode():
        st, _ = lidar_books(model, r["ex0"])
        if st is None:
            log(f"  {name}: no sparse structures (a dense BEV model)")
            return None
        torch.cuda.synchronize()
        share, per_name = profile_call(
            lambda: model.backbone_mod.structures(st.structure),
            "structures+rulebooks build", top=15, host_top=15)
    out = dict(device_busy_share=share,
               device_ms=sum(us for us, _ in per_name.values()) / 1e3,
               kernels=sum(c for _, c in per_name.values()))
    before = BUILD_KERNELS_BEFORE.get(name, "not measured, a later path")
    log(f"  {name} build: {out['kernels']} device kernels (before the fused "
        f"rulebook kernels: {before}), device "
        f"{out['device_ms']:.3f} ms, busy share "
        + ("not measured" if share is None else f"{100 * share:.1f}%"))
    return out


def conv_kernel_sums(per_name):
    """The device time and launches of every kernel name the conv and dW
    wrappers launch (CONV_KERNELS) in one profile, with the conv (forward
    and dX: conv_kernel + conv_reduce) and dW (dw_kernel + dw_reduce)
    totals. A wrapper call is one counted launch but may be two kernels."""
    import re

    pat = re.compile(r"\(anonymous namespace\)::(%s)\b" % "|".join(
        CONV_KERNELS))
    rows, tot = [], {"conv": [0.0, 0], "dw": [0.0, 0]}
    for name, (us, cnt) in sorted(per_name.items(), key=lambda kv: -kv[1][0]):
        m = pat.search(name)
        if m is None:
            continue
        rows.append(dict(name=name[m.start(1):].split("(")[0],
                         ms=us / 1e3, launches=cnt))
        t = tot["dw" if m.group(1).startswith("dw") else "conv"]
        t[0] += us / 1e3
        t[1] += cnt
        log(f"    {us / 1e3:8.3f} ms x{cnt:<5d} {rows[-1]['name']}")
    log(f"    conv (forward + dX) {tot['conv'][0]:.3f} ms over "
        f"{tot['conv'][1]} kernels; dW {tot['dw'][0]:.3f} ms over "
        f"{tot['dw'][1]} kernels; together "
        f"{tot['conv'][0] + tot['dw'][0]:.3f} ms")
    return dict(kernels=rows, conv_ms=tot["conv"][0],
                conv_kernels=tot["conv"][1], dw_ms=tot["dw"][0],
                dw_kernels=tot["dw"][1])


# phases 3r-3t: CenterPoint detection at its published configs, on seeded
# trees with boxes (synthetic.write_semnusc_tree / write_semanticwaymo_tree
# with boxes=20; the nuScenes tree with 9 sweeps of 26,000 returns before
# each key frame, no cameras), seeded weights with BN calibrated on the
# first val frame, through both entry points in-process. 3r: the two
# nuScenes VoxelNet configs (rotated, then circle NMS) through tools.test,
# the first through tools.train at samples_per_gpu=4 (2 epochs of one
# step, then a resume); 3s: the Waymo VoxelNet 3x config through both
# tools (its db_sampler on the tree's gt database from tools.create_data
# waymo_gt_database; B=4: 4 x 150,000 conv rows), then the two-sweep
# velocity config through tools.test; 3t: the Waymo PointPillars config
# through both tools, which launches no kernel of the port. Launches per
# frame and per step on tables (keys, keys, rank, rank), read from the
# dispatch (SpMiddleResNetFHD: 21 convs; a KeyTable rulebook is the front
# end, a merge and the decode, a RankTable one fused launch and a pack):
# a frame builds subm1 down2 subm2 down3 on KeyTables and subm3 down4
# subm4 down5 on RankTables; a step also the inverse rulebooks inv2 (a
# KeyTable) and inv3 inv4 inv5 (RankTables; inv5 packs the table of the
# extra conv's output), and runs 20 dX convs (the mean VFE has no
# parameters: the input conv's features need no gradient) and 21 dW
DET_NU = "configs/nusc/voxelnet/nusc_centerpoint_voxelnet_01voxel"
DET_WY = "configs/waymo/voxelnet/waymo_centerpoint_voxelnet_"
DET_PP = "configs/waymo/pp/waymo_centerpoint_pp_two_pfn_stride1_3x.py"
DET_PER_FRAME = {"rulebook_conv": 21, "rulebook_conv_dw": 0,
                 "rulebook_rank": 4, "rulebook_cells": 4,
                 "rulebook_decode": 4, "lookup_single": 0, "rank_lookup": 0,
                 "rank_pack": 2, "merge_lookup": 4}
DET_PER_STEP = {"rulebook_conv": 41, "rulebook_conv_dw": 21,
                "rulebook_rank": 7, "rulebook_cells": 5,
                "rulebook_decode": 5, "lookup_single": 0, "rank_lookup": 0,
                "rank_pack": 3, "merge_lookup": 5}
DET_NONE = {k: 0 for k in DET_PER_FRAME}
DET_NU_TREE = dict(scenes=("scene-0003", "scene-0001", "scene-0002"),
                   samples=2, points=(30000, 34688), sweeps=9,
                   sweep_points=26000, boxes=20, seed=20)
# Waymo frames without second returns and with 3,000 short-range returns
# (~172,000 points): with the objects the db_sampler pastes a frame stays
# within the config's 180,000-point capacity, which training may not
# overflow (a published-size SemanticWaymo frame has ~186,700)
DET_WY_TREE = dict(frames={"train": 4, "val": 2}, boxes=20, seed=21,
                   second_return=0.0, short_points=3000)
# card vs CPU on one frame of the mini cut: boxes and scores of the valid
# set within TOL_DET (metres, probability), selections exact
TOL_DET = 1e-3
_DET_WY_ROOT = []


def det_tree_nu(tmp):
    """The seeded nuScenes detection tree at the config's data root under
    ``tmp`` and its 10-sweep infos (tools.create_data); -> seconds."""
    from lidarseg3d_torch.synthetic import write_semnusc_tree
    from lidarseg3d_torch.tools import create_data

    t = DET_NU_TREE
    root = os.path.join(tmp, "data/SemanticNusc")
    t0 = time.perf_counter()
    write_semnusc_tree(root, scenes=t["scenes"], samples=t["samples"],
                       points=t["points"], seed=t["seed"], cams=(),
                       boxes=t["boxes"], sweeps=t["sweeps"],
                       sweep_points=t["sweep_points"])
    create_data.main(["semanticnusc", "--root", root, "--nsweeps", "10"])
    return time.perf_counter() - t0


def det_tree_wy(tmp):
    """The seeded Waymo detection tree (written once a run, removed at the
    end) and its gt database (tools.create_data waymo_gt_database), linked
    at data/Waymo under ``tmp``; -> seconds this call spent writing."""
    import atexit
    import shutil
    import tempfile

    from lidarseg3d_torch.synthetic import write_semanticwaymo_tree
    from lidarseg3d_torch.tools import create_data

    t0 = time.perf_counter()
    if not _DET_WY_ROOT:
        root = tempfile.mkdtemp(prefix="waymo_det_tree_")
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        write_semanticwaymo_tree(root, splits=("train", "val"), cams=(),
                                 **DET_WY_TREE)
        create_data.main(["waymo_gt_database", "--root", root])
        _DET_WY_ROOT.append(root)
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    os.symlink(_DET_WY_ROOT[0], os.path.join(tmp, "data/Waymo"))
    return time.perf_counter() - t0


def det_check_outputs(dets, ncls, phase):
    """Every frame's boxes finite, labels in range, at least one valid
    box. -> (frames, valid boxes)."""
    import numpy as np

    nvalid = 0
    for token, d in dets.items():
        v = d["valid"]
        ok = (np.isfinite(d["box3d_lidar"]).all()
              and np.isfinite(d["scores"]).all()
              and ((d["label_preds"] >= 0) & (d["label_preds"] < ncls)).all()
              and v.sum() >= 1
              and ("velocity" not in d or np.isfinite(d["velocity"]).all()))
        if not ok:
            raise SystemExit(f"phase {phase}: frame {token}: non-finite or "
                             f"out-of-range outputs, or no valid box "
                             f"({int(v.sum())} valid)")
        nvalid += int(v.sum())
    return len(dets), nvalid


def det_card_vs_cpu(cfg_path, tmp, phase):
    """The config cut to a mini model (synthetic.write_mini_det_config)
    over the same tree, seeded and BN-calibrated on the card, then on the
    CPU with the same state: one val frame's forward and decode. The
    selections (valid, labels) equal, boxes and scores of the valid set
    within TOL_DET. -> the largest differences."""
    cfg_path = os.path.abspath(cfg_path)
    import numpy as np
    import torch
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.synthetic import write_mini_det_config
    from lidarseg3d_torch.tools.test import input_shape_of, model_config
    from lidarseg3d_torch.utils.config import Config

    cfg0 = Config.fromfile(cfg_path)
    root = os.path.join(tmp, cfg0.data.val.root_path)
    mini = write_mini_det_config(os.path.join(tmp, "mini_det.py"), cfg_path,
                                 os.path.realpath(root), max_points=400000)
    cfg = Config.fromfile(mini)
    ishape = input_shape_of(cfg)
    ds = dataset_in(cfg, "val", tmp)
    out, sds = {}, None
    for dev in (DEV, "cpu"):
        m = build_detector(model_config(cfg), device=dev)
        ex = first_example(ds, caps(cfg), ishape, dev)
        if sds is None:
            calibrate_bn(m, ex)
            sds = m.state_dict()
        else:
            m.load_state_dict({k: v.cpu() for k, v in sds.items()})
        with torch.inference_mode():
            ret, bat = m.eval()(ex)
            p = m.predict(ret, bat)
        out[dev] = {k: p[k].cpu().numpy() for k in
                    ("box3d_lidar", "scores", "label_preds", "valid")}
    a, b = out[DEV], out["cpu"]
    v = b["valid"]
    if not (np.array_equal(a["valid"], v) and np.array_equal(
            a["label_preds"][v], b["label_preds"][v])) or not v.any():
        raise SystemExit(f"phase {phase}: card vs CPU selections differ "
                         f"({int(a['valid'].sum())} vs {int(v.sum())} valid)")
    err = {k: float(np.abs(a[k][v] - b[k][v]).max())
           for k in ("box3d_lidar", "scores")}
    if max(err.values()) > TOL_DET:
        raise SystemExit(f"phase {phase}: card vs CPU {err} > {TOL_DET}")
    log(f"  card vs CPU (the mini cut, one frame, {int(v.sum())} valid "
        f"boxes): selections equal, max |err| boxes "
        f"{err['box3d_lidar']:.2e}, scores {err['scores']:.2e} "
        f"(limit {TOL_DET})")
    return err


def det_eval(phase, cfg_path, tmp, per_frame, card_vs_cpu=True,
             profile=False):
    """One published detection config through tools.test (module notes
    above): seeded weights, BN calibrated on frame 0, a checkpoint by
    save_checkpoint; the launches per frame held to ``per_frame``, the
    outputs checked, the prediction pkl (and nuScenes JSON) written; one
    frame's forward and decode timed, together and each alone; the mini
    cut card vs CPU. With ``profile``, phase 5 profiles the frame. The
    loader runs threads (with_loader)."""
    cfg_path = with_loader(cfg_path, os.path.join(
        tmp, os.path.basename(cfg_path)), "thread")
    import numpy as np
    import torch
    from lidarseg3d_torch.apis.train import TrainState, save_checkpoint
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.tools import test as tool
    from lidarseg3d_torch.tools.test import input_shape_of, model_config
    from lidarseg3d_torch.utils.config import Config

    cfg = Config.fromfile(cfg_path)
    name = os.path.basename(cfg_path)[:-3]
    work = os.path.join(tmp, "work_" + name)
    ishape = input_shape_of(cfg)
    ds = dataset_in(cfg, "val", tmp)
    model = build_detector(model_config(cfg), device=DEV)
    ex = first_example(ds, caps(cfg), ishape, DEV)
    calibrate_bn(model, ex)
    save_checkpoint(work, TrainState(0, model, None, None), 1)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    cwd = os.getcwd()
    os.chdir(tmp)  # the config's relative data paths
    try:
        out = tool.main([cfg_path, "--checkpoint", work, "--device", DEV,
                         "--work_dir", work])
    finally:
        os.chdir(cwd)
    launches = {k: w.launches for k, w in ws.items()}
    want = {k: len(ds) * c for k, c in per_frame.items()}
    if launches != want:
        raise SystemExit(f"phase {phase} {name}: launches {launches}, "
                         f"expected {want}")
    ncls = len(cfg.class_names)
    frames, nvalid = det_check_outputs(out["detections"], ncls, phase)
    files = sorted(os.listdir(work))
    if "det_predictions.pkl" not in files or (
            cfg.dataset_type == "SemanticNuscDataset"
            and "nusc_det_results.json" not in files):
        raise SystemExit(f"phase {phase} {name}: wrote {files}")
    nvox = int(ex["num_voxels"].sum())
    ms, fwd_ms, dec_ms = [], [], []

    def timed(fn, out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return r

    with torch.inference_mode():
        for _ in range(4):
            timed(lambda: model.predict(*model.eval()(ex)), ms)
        for _ in range(4):
            ret, bat = timed(lambda: model.eval()(ex), fwd_ms)
            timed(lambda: model.predict(ret, bat), dec_ms)
    log(f"  {name}: {frames} frames, {nvalid} valid boxes, launches "
        f"{launches} (per frame {per_frame}); frame 0 {nvox} voxels, "
        f"{int(ex['point_valid'].sum())} points; forward + decode ms "
        f"{[round(x, 2) for x in ms]} (after the first: mean "
        f"{np.mean(ms[1:]):.2f}); alone: forward ms "
        f"{[round(x, 2) for x in fwd_ms]}, decode ms "
        f"{[round(x, 2) for x in dec_ms]}; wrote {files}")
    res = dict(frames=frames, valid_boxes=nvalid, voxels=nvox,
               forward_decode_ms=ms, forward_ms=fwd_ms, decode_ms=dec_ms)
    if card_vs_cpu:
        res["card_vs_cpu"] = det_card_vs_cpu(cfg_path, tmp, phase)
    return dict(model=model, ex0=ex, launches=launches, result=res,
                no_profile=not profile, no_structures=True, work=work,
                tmp=tmp, cfg=cfg, cfg_path=cfg_path,
                detections=out["detections"])


def det_train(phase, cfg_path, tmp, per_step, profile=False):
    """The config trained through tools.train at its samples_per_gpu=4:
    2 epochs of one step (each step's launches held to ``per_step``, the
    loss terms finite, every parameter moved), then a resume for a third
    epoch whose loaded state must equal epoch_2's checkpoint exactly; the
    step times and the peak memory; the first batch for phase 4 (and with
    ``profile``, the resumed state and a train step for phase 5). The
    loader runs threads (with_loader)."""
    cfg_path = with_loader(cfg_path, os.path.join(
        tmp, os.path.basename(cfg_path)), "thread")
    import numpy as np
    import torch
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.datasets import SegDataLoader
    from lidarseg3d_torch.tools import train as tool
    from lidarseg3d_torch.tools.test import input_shape_of
    from lidarseg3d_torch.utils.config import Config

    cfg = Config.fromfile(cfg_path)
    name = os.path.basename(cfg_path)[:-3]
    work = os.path.join(tmp, "train_" + name)
    B = cfg.data.samples_per_gpu
    args = [cfg_path, "--work_dir", work, "--max_steps_per_epoch", "1",
            "--device", DEV]
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    record, timings = {}, []
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        tool.main(args + ["--total_epochs", "2"],
                  hooks=[train_entry_hook(ws, per_step, record, phase,
                                          zero_grad_ok=True)],
                  timings=timings)
        launches = {k: w.launches for k, w in ws.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        files = sorted(os.listdir(work))
        if files != ["epoch_1", "epoch_2", "latest.txt", "train.log"] or \
                launches != {k: 2 * c for k, c in per_step.items()}:
            raise SystemExit(f"phase {phase} {name}: {files}, launches "
                             f"{launches}, expected 2 x {per_step}")

        class Check(tr.TrainerHook):
            def before_run(self, state, loop):
                self.diff = state_equals_checkpoint(
                    state, os.path.join(work, "epoch_2"))
                self.start = (int(state.step), int(state.opt_state.count))

            def after_iter(self, state, ldict, global_step):
                self.first = getattr(self, "first", global_step)

            def after_run(self, state):
                self.state = state

        check = Check()
        tool.main(args + ["--resume_from", "--total_epochs", "3"],
                  hooks=[check, train_entry_hook(ws, per_step, record,
                                                 phase, zero_grad_ok=True)])
        if check.diff or check.start != (2, 2) or check.first != 2:
            raise SystemExit(f"phase {phase} {name} resume: differs in "
                             f"{check.diff[:5]}; starts at {check.start}, "
                             f"first step {check.first}")
        ds = dataset_in(cfg, "train", tmp)
        with SegDataLoader(ds, B, **caps(cfg), shuffle=False,
                           num_workers=1) as loader:
            ex = tr.example_to_device(next(loader.epoch(0)), DEV)
        ex["input_shape"] = input_shape_of(cfg)
    finally:
        os.chdir(cwd)
    steps = [round(x["step_s"] * 1e3, 2) for x in timings]
    waits = [round(x["data_s"] * 1e3, 2) for x in timings]
    log(f"  {name} at B={B}: 2 steps, launches {launches} (per step "
        f"{per_step}); {record['moved']} parameters moved but "
        f"{record['zero_grad']} (a zero gradient at every step); resume "
        f"equal to epoch_2, started at step 2; step ms {steps}, loader "
        f"wait ms {waits}; peak memory {peak:.2f} GiB; batch 0 voxels "
        f"{ex['num_voxels'].tolist()}")
    for step, vals in record["losses"]:
        log(f"  step {step}: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in vals.items()))
    model = check.state.model
    more = {}
    if profile:
        from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

        opt, _ = build_one_cycle_optimizer(
            dict(cfg.optimizer), dict(cfg.lr_config), 3,
            grad_clip=cfg.optimizer_config.grad_clip.max_norm)
        more = dict(state=check.state, step=tr.make_train_step(
            model, opt, input_shape_of(cfg)))
    return dict(model=model, ex0=ex, launches=launches,
                no_profile=not profile, **more,
                result=dict(step_ms=steps, loader_wait_ms=waits,
                            peak_gib=peak, moved=record["moved"],
                            voxels=ex["num_voxels"].tolist(),
                            step_ms_p50=float(np.percentile(
                                [x["step_s"] * 1e3 for x in timings], 50))))


def run_det_nu():
    """Phase 3r (module notes above)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="det_nu_")
    secs = det_tree_nu(tmp)
    log(f"  tree: {DET_NU_TREE} written with its infos in {secs:.1f} s")
    out = {"det_nu_eval": det_eval("3r", DET_NU + ".py", tmp,
                                   DET_PER_FRAME, profile=True),
           "det_nu_circle_eval": det_eval("3r", DET_NU + "_circle_nms.py",
                                          tmp, DET_PER_FRAME,
                                          card_vs_cpu=False),
           "det_nu_train": det_train("3r", DET_NU + ".py", tmp,
                                     DET_PER_STEP)}
    return out


def run_det_wy():
    """Phase 3s (module notes above)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="det_wy_")
    secs = det_tree_wy(tmp)
    log(f"  tree: {DET_WY_TREE} and its gt database written in "
        f"{secs:.1f} s")
    return {"det_wy_eval": det_eval("3s", DET_WY + "3x.py", tmp,
                                    DET_PER_FRAME),
            "det_wy_train": det_train("3s", DET_WY + "3x.py", tmp,
                                      DET_PER_STEP, profile=True),
            "det_wy_velo_eval": det_eval(
                "3s", DET_WY + "two_sweeps_3x_with_velo.py", tmp,
                DET_PER_FRAME, card_vs_cpu=False)}


def run_det_pp():
    """Phase 3t (module notes above)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="det_pp_")
    det_tree_wy(tmp)
    return {"det_pp_eval": det_eval("3t", DET_PP, tmp, DET_NONE),
            "det_pp_train": det_train("3t", DET_PP, tmp, DET_NONE)}


# phase 3u: two-stage CenterPoint at its published Waymo config (the 3x
# VoxelNet frozen as its first stage, NMS_POST_MAXSIZE=500, the 5-point BEV
# extractor, the RoI head of 2560 -> 256 -> 256 and two (256, 256)
# branches, DP_RATIO=0.3) through tools.test on the det-wy tree's two val
# frames (BN calibrated on frame 0) and tools.train at B=4. The frozen
# first stage runs without autograd, so a frame and a step launch what a
# det-wy frame does (no dX, dW or inverse rulebook). The step starts from
# a checkpoint whose first stage is a fixed proposer (its head's output
# convs zero, their biases a 0.8 x 0.8 x 1.8 m pedestrian, yaw 0, in 100
# cells of one BEV row shifted to start at the origin: rows of touching
# boxes, 0 m to 79.2 m along x) over a copy of the tree that puts a
# pedestrian of that size at the origin of every train frame: a global
# rotation, flip or scaling keeps it there, so a RoI overlaps it (IoU >
# 0.55 at any rotation) and the regression branch has a foreground row
TSD = ("configs/waymo/voxelnet/two_stage/waymo_centerpoint_voxelnet_"
       "two_stage_bev_5point_ft_6epoch_freeze.py")
TSD_PED = (0.8, 0.8, 1.8)  # the origin pedestrian (length, width, height)
TSD_SHIFT = 94  # BEV cells from the grid's corner to the origin (75.2 / 0.8)
_TSD_ROOT = []


def tsd_tree(tmp):
    """A copy of the det-wy tree (det_tree_wy) whose train frames hold a
    pedestrian at the origin with 40 returns inside, linked at data/Waymo
    under ``tmp``; -> seconds."""
    import pickle
    import shutil
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    if not _DET_WY_ROOT:
        det_tree_wy(tempfile.mkdtemp(prefix="det_wy_src_"))
    src = _DET_WY_ROOT[0]
    root = os.path.join(tempfile.mkdtemp(prefix="tsd_tree_"), "waymo")
    shutil.copytree(src, root)
    _TSD_ROOT.append(root)
    for name in os.listdir(root):  # the infos name their frames by path
        if name.startswith("infos_"):
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                infos = pickle.load(f)
            for info in infos:
                info["path"] = info["path"].replace(src, root)
                for sw in info.get("sweeps", []):
                    sw["path"] = sw["path"].replace(src, root)
            with open(path, "wb") as f:
                pickle.dump(infos, f)
    rng = np.random.default_rng(22)
    l, w, h = TSD_PED
    for name in sorted(os.listdir(os.path.join(root, "train_frames"))):
        path = os.path.join(root, "train_frames", name)
        with open(path, "rb") as f:
            obj = pickle.load(f)
        lid, anns = obj["lidars"], obj["annotations"]
        xyz = rng.uniform(-0.45, 0.45, (40, 3)) * (l, w, h) + (0, 0, h / 2)
        lid["points_xyz"] = np.concatenate([lid["points_xyz"], xyz]).astype(
            lid["points_xyz"].dtype)
        lid["points_feature"] = np.concatenate([
            lid["points_feature"], np.full((40, lid["points_feature"]
                                            .shape[1]), 0.5)]).astype(
            lid["points_feature"].dtype)
        if "points_cp" in lid:
            lid["points_cp"] = np.concatenate([
                lid["points_cp"], np.zeros((40, lid["points_cp"].shape[1]),
                                           lid["points_cp"].dtype)])
        box = np.array([[0.0, 0.0, h / 2, l, w, h, 0.0]], np.float32)
        anns["gt_boxes"] = np.concatenate([anns["gt_boxes"], box])
        anns["gt_names"] = np.concatenate([anns["gt_names"],
                                           np.array(["PEDESTRIAN"], object)])
        anns["gt_num_points"] = np.concatenate([anns["gt_num_points"],
                                                np.array([40], np.int32)])
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    os.symlink(root, os.path.join(tmp, "data/Waymo"))
    return time.perf_counter() - t0


def tsd_fixed_proposer(model):
    """Make the first stage's head the fixed proposer of the module notes
    above (weights of the model's own layers; the model is unchanged)."""
    import math

    import torch
    from lidarseg3d_torch.models.bbox_heads.center_head import SepHead

    l, w, h = TSD_PED
    bias = {"hm": [-5.0, 0.0, -5.0], "reg": [TSD_SHIFT, TSD_SHIFT],
            "height": [h / 2], "dim": [math.log(l), math.log(w), math.log(h)],
            "rot": [0.0, 1.0]}
    heads = [m for m in model.single_det.head_mod.modules()
             if isinstance(m, SepHead)]
    with torch.no_grad():
        for sep in heads:
            for name, (_, out) in sep.heads.items():
                out.weight.zero_()
                out.bias.copy_(torch.tensor(bias[name]))
    return len(heads)


def tsd_split_ms(model, ex, reps=4):
    """ms of a frame's first-stage forward, proposals, second stage and
    predict, each alone (host clock to a synchronisation)."""
    import torch

    out = {k: [] for k in ("forward", "proposals", "second_stage",
                           "predict")}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[key].append((time.perf_counter() - t0) * 1e3)
        return r

    m = model.eval()
    with torch.inference_mode():
        for _ in range(reps):
            rets, bat = timed("forward", lambda: m.single_det(ex))
            props = timed("proposals", lambda: m.proposals(rets, bat))
            r = timed("second_stage", lambda: m.refine(bat, props))
            timed("predict", lambda: m.predict(r, bat))
    return out


def tsd_train(tmp, per_step):
    """The published two-stage config through tools.train at B=4 from the
    fixed-proposer checkpoint (epoch_0), 2 epochs of one step, then a
    resume: each step's launches held to ``per_step``; the RoI head's
    regression branch gets a non-zero gradient in some step; every
    first-stage gradient is 0, its parameters after each step equal the
    decay-only update p - lr * wd * p and its BN statistics stay bit for
    bit; the resumed state equals epoch_2's checkpoint."""
    cfg_path = with_loader(TSD, os.path.join(tmp, os.path.basename(TSD)),
                           "thread")
    import numpy as np
    import torch
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.datasets import SegDataLoader
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer
    from lidarseg3d_torch.tools import train as tool
    from lidarseg3d_torch.tools.test import input_shape_of, model_config
    from lidarseg3d_torch.utils.config import Config

    cfg = Config.fromfile(cfg_path)
    work = os.path.join(tmp, "train_tsd")
    model = build_detector(model_config(cfg), device=DEV)
    nheads = tsd_fixed_proposer(model)
    opt, _ = build_one_cycle_optimizer(dict(cfg.optimizer),
                                       dict(cfg.lr_config), 2)
    tr.save_checkpoint(work, tr.create_train_state(model, opt), 0)
    del model
    wd = float(cfg.optimizer.wd)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0

    class Check(tr.TrainerHook):
        def before_run(self, state, loop):
            self.lr_fn = loop["lr_fn"]
            m = state.model
            self.first = {k: p.detach().clone() for k, p in
                          m.single_det.named_parameters()}
            self.stats = {k: v.clone() for k, v in
                          m.single_det.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}
            layers, out = m.roi_head_mod.reg
            self.reg = [p for lin, bn in layers for p in (
                *lin.parameters(), *bn.parameters())] + list(
                out.parameters())
            self.reg_grad, self.reg_loss, self.decay_err = [], [], 0.0

        def after_iter(self, state, ldict, global_step):
            m = state.model
            self.reg_grad.append(max(float(p.grad.abs().max())
                                     for p in self.reg))
            self.reg_loss.append(float(ldict["rcnn_loss_reg"]))
            lr = float(self.lr_fn(int(state.opt_state.count) - 1))
            for k, p in m.single_det.named_parameters():
                if p.grad is None or p.grad.any():
                    raise SystemExit(f"phase 3u step {global_step}: the "
                                     f"frozen {k} has a gradient")
                prev = self.first[k]
                want = prev + (prev * wd) * (-lr)
                err = float(((p.detach() - want).abs()
                             / (1e-7 + want.abs())).max())
                self.decay_err = max(self.decay_err, err)
                if err > 1e-5:
                    raise SystemExit(f"phase 3u step {global_step}: the "
                                     f"frozen {k} is not its decay-only "
                                     f"update ({err:.2e} relative)")
                self.first[k] = p.detach().clone()
            sd = m.single_det.state_dict()
            moved = [k for k, v in self.stats.items()
                     if not torch.equal(sd[k], v)]
            if moved:
                raise SystemExit(f"phase 3u: frozen BN statistics moved: "
                                 f"{moved[:3]}")

    record, timings, check = {}, [], Check()
    args = [cfg_path, "--work_dir", work, "--max_steps_per_epoch", "1",
            "--device", DEV]
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        tool.main(args + ["--resume_from", "0", "--total_epochs", "2"],
                  hooks=[check, train_entry_hook(ws, per_step, record, "3u",
                                                 zero_grad_ok=True)],
                  timings=timings)
        launches = {k: w.launches for k, w in ws.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        files = sorted(os.listdir(work))
        if files != ["epoch_0", "epoch_1", "epoch_2", "latest.txt",
                     "train.log"]:
            raise SystemExit(f"phase 3u: wrote {files}")
        if max(check.reg_grad) == 0.0:
            raise SystemExit("phase 3u: the RoI head's regression branch "
                             f"got no gradient (rcnn_loss_reg "
                             f"{check.reg_loss})")

        class Resume(tr.TrainerHook):
            def before_run(self, state, loop):
                self.diff = state_equals_checkpoint(
                    state, os.path.join(work, "epoch_2"))
                self.start = (int(state.step), int(state.opt_state.count))

            def after_run(self, state):
                self.model, self.state = state.model, state

        resume = Resume()
        tool.main(args + ["--resume_from", "--total_epochs", "3"],
                  hooks=[resume, train_entry_hook(ws, per_step, {}, "3u",
                                                  zero_grad_ok=True)])
        if resume.diff or resume.start != (2, 2):
            raise SystemExit(f"phase 3u resume: differs in "
                             f"{resume.diff[:5]}, starts at {resume.start}")
        ds = dataset_in(cfg, "train", tmp)
        with SegDataLoader(ds, cfg.data.samples_per_gpu, **caps(cfg),
                           shuffle=False, num_workers=1) as loader:
            ex = tr.example_to_device(next(loader.epoch(0)), DEV)
        ex["input_shape"] = input_shape_of(cfg)
    finally:
        os.chdir(cwd)
    steps = [round(x["step_s"] * 1e3, 2) for x in timings]
    log(f"  two-stage at B=4 ({nheads} first-stage head(s) fixed): 2 steps, "
        f"launches {launches} (per step {per_step}); RoI regression "
        f"gradient max {[f'{g:.3e}' for g in check.reg_grad]}, "
        f"rcnn_loss_reg {[round(x, 4) for x in check.reg_loss]}; frozen "
        f"first stage: gradients 0, decay-only update within "
        f"{check.decay_err:.2e}, BN statistics bit for bit; resume equal "
        f"to epoch_2; step ms {steps}, loader wait ms "
        f"{[round(x['data_s'] * 1e3, 2) for x in timings]}; peak memory "
        f"{peak:.2f} GiB")
    for step, vals in record["losses"]:
        log(f"  step {step}: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in vals.items()))
    # phase 5 profiles a step of the resumed state
    opt, _ = build_one_cycle_optimizer(
        dict(cfg.optimizer), dict(cfg.lr_config), 3,
        grad_clip=cfg.optimizer_config.grad_clip.max_norm)
    return dict(model=resume.model, ex0=ex, launches=launches,
                state=resume.state, step=tr.make_train_step(
                    resume.model, opt, input_shape_of(cfg)),
                result=dict(step_ms=steps, peak_gib=peak,
                            reg_grad_max=check.reg_grad,
                            rcnn_loss_reg=check.reg_loss,
                            decay_only_max_rel_err=check.decay_err,
                            moved=record["moved"]))


def run_tsd():
    """Phase 3u (module notes above)."""
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="tsd_")
    secs = tsd_tree(tmp)
    log(f"  tree: the det-wy tree with a pedestrian at the origin of each "
        f"train frame, in {secs:.1f} s")
    ev = det_eval("3u", TSD, tmp, DET_PER_FRAME, profile=True)
    split = tsd_split_ms(ev["model"], ev["ex0"])
    log("  a frame alone, ms: " + "; ".join(
        f"{k} {[round(x, 2) for x in v]}" for k, v in split.items())
        + " (first-stage forward, its decode at 500 rows, the extractor "
        "and RoI head, predict)")
    ev["result"]["split_ms"] = split
    ev["result"]["split_ms_mean"] = {k: float(np.mean(v[1:]))
                                     for k, v in split.items()}
    return {"tsd_eval": ev, "tsd_train": tsd_train(tmp, DET_PER_FRAME)}


# phase 3v: the tools around detection and single frames: the nuScenes
# tracker on the detection JSON 3r's tools.test wrote, the Waymo tracker
# on det-wy-velo's det_predictions.pkl (3s) over the tree's moving vehicle
# poses (stopping before the metrics_pb2 writer, which needs
# waymo_open_dataset), tools.single_inference on a published-size scan
# through the published SemanticKITTI SDSeg3D config (its labels against
# tools.test's on the same scan), tools.simple_inference_waymo on a frame
# of the det-wy tree through the 3x config (its boxes against 3s's
# tools.test), and the C voxelizer against numpy, byte for byte, both
# timed per frame at the published Waymo and SemanticKITTI sizes
VOX_REPS = 5


def voxelizer_ms(name, points, vg_cfg):
    """The C voxelizer and the numpy path on one frame: byte for byte, and
    their median ms over VOX_REPS calls each."""
    import numpy as np
    from lidarseg3d_torch.core import native_voxelize
    from lidarseg3d_torch.core import voxelize as vox

    mv = vg_cfg["max_voxel_num"]
    mv = mv[1] if isinstance(mv, (list, tuple)) else mv
    args = (points, vg_cfg["voxel_size"], vg_cfg["range"],
            vg_cfg["max_points_in_voxel"], mv)
    grid = vox.compute_grid_size(vg_cfg["range"], vg_cfg["voxel_size"])
    times = {}
    for key, fn in (("c", lambda: native_voxelize.points_to_voxel_native(
            *args, grid)), ("numpy", lambda: vox.points_to_voxel_numpy(
                *args))):
        out, ts = None, []
        for _ in range(VOX_REPS):
            t0 = time.perf_counter()
            out = fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[key] = (out, float(np.median(ts)))
    a, b = times["c"][0], times["numpy"][0]
    if not all(x.dtype == y.dtype and x.shape == y.shape
               and x.tobytes() == y.tobytes() for x, y in zip(a, b)):
        raise SystemExit(f"phase 3v: the C voxelizer differs from numpy on "
                         f"{name}")
    res = dict(points=len(points), voxels=len(a[0]), c_ms=times["c"][1],
               numpy_ms=times["numpy"][1],
               speedup=times["numpy"][1] / times["c"][1])
    log(f"  voxelizer {name}: {len(points)} points -> {len(a[0])} voxels, "
        f"byte for byte; C {res['c_ms']:.2f} ms, numpy "
        f"{res['numpy_ms']:.2f} ms a frame (median of {VOX_REPS}; "
        f"{res['speedup']:.1f}x)")
    return res


def run_frame_tools(runs):
    """Phase 3v (module notes above)."""
    import json
    import pickle
    import tempfile

    import numpy as np
    from lidarseg3d_torch.synthetic import write_semantickitti_tree
    from lidarseg3d_torch.tools import (nusc_tracking, simple_inference_waymo,
                                        single_inference, waymo_tracking)
    from lidarseg3d_torch.tools import test as test_tool
    from lidarseg3d_torch.utils.config import Config

    need = ("det_nu_eval", "det_wy_eval", "det_wy_velo_eval")
    if any(k not in runs for k in need):
        raise SystemExit("phase 3v reads the outputs of phases 3r and 3s: "
                         "run them with it")
    res = {}
    tmp = tempfile.mkdtemp(prefix="frame_tools_")
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    # the nuScenes tracker on 3r's detection JSON
    nu = runs["det_nu_eval"]
    info = os.path.join(nu["tmp"], nu["cfg"].data.val.info_path)
    t0 = time.perf_counter()
    path = nusc_tracking.main([
        "--checkpoint", os.path.join(nu["work"], "nusc_det_results.json"),
        "--info_path", info, "--work_dir", os.path.join(tmp, "nusc_track")])
    secs = time.perf_counter() - t0
    with open(path) as f:
        tracks = json.load(f)["results"]
    ids = [a["tracking_id"] for r in tracks.values() for a in r]
    if len(tracks) != nu["result"]["frames"] or not ids:
        raise SystemExit(f"phase 3v: nusc tracking gave {len(tracks)} "
                         f"frames, {len(ids)} tracks")
    res["nusc_tracking"] = dict(frames=len(tracks), boxes=len(ids),
                                tracks=len(set(ids)), seconds=secs)
    log(f"  nusc_tracking: {len(tracks)} frames, {len(ids)} tracked boxes "
        f"in {len(set(ids))} tracks, {secs * 1e3:.1f} ms")
    # the Waymo tracker on det-wy-velo's prediction pkl
    wv = runs["det_wy_velo_eval"]
    with open(os.path.join(wv["work"], "det_predictions.pkl"), "rb") as f:
        preds = pickle.load(f)
    info = os.path.join(wv["tmp"], wv["cfg"].data.val.info_path)
    with open(info, "rb") as f:
        infos = pickle.load(f)
    t0 = time.perf_counter()
    got = waymo_tracking.track(
        preds, infos, {"VEHICLE": 0.8, "PEDESTRIAN": 0.4, "CYCLIST": 0.6},
        info_dir=os.path.dirname(info))
    secs = time.perf_counter() - t0
    n = sum(len(g["tracking_ids"]) for g in got.values())
    poses = [waymo_tracking.load_pose_ts(i, os.path.dirname(info))[0]
             for i in infos]
    if len(got) != len(preds) or np.allclose(poses[0], np.eye(4)) or not \
            all(np.isfinite(g["global_box3d"]).all() for g in got.values()):
        raise SystemExit("phase 3v: the Waymo tracker's frames or global "
                         "boxes are wrong")
    res["waymo_tracking"] = dict(frames=len(got), boxes=n, seconds=secs)
    log(f"  waymo_tracking (velo predictions, moving poses): {len(got)} "
        f"frames, {n} active tracked boxes, {secs * 1e3:.1f} ms (the "
        "metrics_pb2 writer needs waymo_open_dataset: not run)")
    # simple_inference_waymo on frame 0 of 3s's val split, 3x config
    wy = runs["det_wy_eval"]
    with open(os.path.join(wy["tmp"], wy["cfg"].data.val.info_path),
              "rb") as f:
        info0 = pickle.load(f)[0]
    frame = os.path.join(wy["tmp"], info0["path"]) \
        if not os.path.isabs(info0["path"]) else info0["path"]
    t0 = time.perf_counter()
    dets = simple_inference_waymo.main([
        wy["cfg_path"], "--checkpoint", wy["work"], "--frame", frame,
        "--device", DEV, "--visual", os.path.join(tmp, "bev.png")])
    secs = time.perf_counter() - t0
    want = wy["detections"][info0["token"]]
    v = want["valid"]
    err = max(float(np.abs(dets[k] - want[k][v]).max()) if v.any() else 0.0
              for k in ("box3d_lidar", "scores"))
    if not np.array_equal(dets["label_preds"], want["label_preds"][v]) or \
            err > TOL_DET:
        raise SystemExit(f"phase 3v: simple_inference_waymo differs from "
                         f"tools.test ({len(dets['scores'])} vs "
                         f"{int(v.sum())} boxes, {err:.2e})")
    res["simple_inference_waymo"] = dict(boxes=len(dets["scores"]),
                                         max_abs_err=err, seconds=secs)
    log(f"  simple_inference_waymo: {len(dets['scores'])} boxes, equal to "
        f"tools.test's within {err:.2e}; {secs:.2f} s with the model's "
        "build and load")
    # single_inference on a published-size SemanticKITTI scan, SDSeg3D
    cfg_path = with_loader(EVAL_SD["config"], os.path.join(
        tmp, "sdseg.py"), "thread")
    cfg = Config.fromfile(cfg_path)
    root = os.path.join(tmp, cfg.data_root)
    write_semantickitti_tree(root, sequences=("08",), frames=1,
                             points=(120000, 125000), seed=23,
                             image_hw=(376, 1241), max_range=75.0)
    ds = dataset_in(cfg, "val", tmp)
    from lidarseg3d_torch.apis.train import TrainState, save_checkpoint
    from lidarseg3d_torch.models import build_detector

    model = build_detector(test_tool.model_config(cfg), device=DEV)
    calibrate_bn(model, first_example(ds, caps(cfg),
                                      test_tool.input_shape_of(cfg), DEV))
    work = os.path.join(tmp, "work_sdseg")
    save_checkpoint(work, TrainState(0, model, None, None), 1)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        want = test_tool.main([cfg_path, "--checkpoint", work, "--device",
                               DEV, "--work_dir", work])["detections"]
    finally:
        os.chdir(cwd)
    (token, pred), = want.items()
    scan = next(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                for f in fs if f.endswith(".bin")
                and os.path.join(dp, f).endswith(token))
    t0 = time.perf_counter()
    labels = single_inference.main([cfg_path, "--checkpoint", work,
                                    "--scan", scan, "--device", DEV])
    secs = time.perf_counter() - t0
    agree = float((labels == pred["pred_point_sem_labels"]).mean())
    if labels.shape != pred["pred_point_sem_labels"].shape or \
            agree < MIN_LABEL_AGREE or labels.max() >= EVAL_SD["ncls"]:
        raise SystemExit(f"phase 3v: single_inference labels agree with "
                         f"tools.test on {agree:.6f} of the points")
    res["single_inference"] = dict(points=len(labels), agree=agree,
                                   classes=int(len(np.unique(labels))),
                                   seconds=secs)
    log(f"  single_inference (SDSeg3D, {len(labels)} points): "
        f"{len(np.unique(labels))} classes, labels equal to tools.test's on "
        f"{agree:.6f} of the points; {secs:.2f} s with the model's build "
        "and load")
    # the C voxelizer at the published sizes
    with open(frame, "rb") as f:
        lid = pickle.load(f)["lidars"]
    wpts = np.concatenate([lid["points_xyz"], lid["points_feature"]],
                          1).astype(np.float32)[:, :5]
    res["voxelizer_waymo"] = voxelizer_ms(
        "Waymo 3x (0.1 x 0.1 x 0.15 m, 150,000 voxels)", wpts,
        wy["cfg"].voxel_generator)
    kpts = np.fromfile(scan, np.float32).reshape(-1, 4)
    res["voxelizer_semkitti"] = voxelizer_ms(
        "SemanticKITTI SDSeg3D", kpts, cfg.voxel_generator)
    return {"frame_tools": dict(result=res, no_profile=True, launches={
        k: w.launches for k, w in ws.items()})}


# phase 3w: the last modules. UNetCylinder3D on the cylindrical grid that
# the published Cylinder3D nuScenes config's VFE builds (480 x 360 x 32,
# capacity 120,000; r=2 and 16 input features, as the VFE's fea_compre
# gives them) from a seeded 32-beam scan, held bit for bit on the card
# against UNetSCN3D with the same weights; tools.warm_cache on the
# published SemanticKITTI MSeg3D config (its train and eval step on the
# synthetic batch of the config's shapes at samples_per_gpu=2, the
# launches of 3e's step plus 3d's frame); tools.synthetic_e2e, the train
# -> checkpoint -> eval -> TTA closure, cut to 6 frames and 12 epochs at
# B=2 (36 steps, then 6 frames plain and 6 with TTA of the mini config's
# all-rank tables) and held to the tool's TTA check and to 0.05: the JAX
# package's own tools/synthetic_e2e.py at this cut reads 0.1086, the
# port's CPU readings over four seeds of its initialization 0.0761-0.1350,
# a model that predicts one class at most 0.0220
# (tests/test_torch_port_synthetic_e2e.py). The full closure, 40 frames
# at the tool's 0.85, takes ~3 minutes of host-bound ~0.2 s steps, so it
# runs as its own command on the card:
#   python -m lidarseg3d_torch.tools.synthetic_e2e --epochs 40
# (20 epochs, the tool's default, clear 0.85 in neither package; PERF.md)
CYL_UNET = dict(config=CYL + "_lr1en2_e12.py", points=34688, seed=30,
                ratio=2, max_range=50.0, convs=36)
WARM = EVAL["config"]
E2E = dict(frames=6, epochs=12, batch_size=2, min_miou=0.05)
# a training step / an evaluation frame on tables of rank only (3c's)
RANK_STEP = {"rulebook_conv": 71, "rulebook_conv_dw": 36,
             "rulebook_rank": 10, "rulebook_cells": 0, "rulebook_decode": 0,
             "lookup_single": 1, "rank_lookup": 0, "rank_pack": 4,
             "merge_lookup": 0}
RANK_FRAME = dict(RANK_STEP, rulebook_conv=36, rulebook_conv_dw=0)
# 3e's step: 3d's frame (tables keys, keys, rank, rank), 35 dX, 36 dW
KEYS_STEP = dict(KEYS_KEYS_RANK_RANK, rulebook_conv=71, rulebook_conv_dw=36)


def zero_launches():
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    return ws


def expect_launches(phase, what, ws, per):
    """The launches since zero_launches() -> a dict; fails unless they
    are ``per``'s."""
    got = {k: w.launches for k, w in ws.items()}
    if got != per:
        raise SystemExit(f"phase {phase} {what}: launches {got}, expected "
                         f"{per}")
    log(f"  {what} launches: " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v))
    return got


def run_cyl_unet():
    """Phase 3w's UNetCylinder3D (notes above)."""
    import numpy as np
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_backbone, build_reader
    from lidarseg3d_torch.models.layers import init_parameters
    from lidarseg3d_torch.utils.config import Config

    c = CYL_UNET
    cfg = Config.fromfile(c["config"])
    rd = cfg.model["reader"].to_dict()
    gen = torch.Generator().manual_seed(c["seed"])
    vfe = build_reader(rd)
    init_parameters(vfe, gen)
    vfe = vfe.to(DEV).eval()
    N = cfg.capacity["max_points"]
    pts, _ = syn._nusc_scan(np.random.default_rng(c["seed"]), c["points"],
                            c["max_range"])
    points = np.zeros((1, N, pts.shape[1]), np.float32)
    points[0, :len(pts)] = pts
    valid = np.arange(N)[None] < len(pts)
    with torch.inference_mode():
        st = vfe(torch.from_numpy(points).to(DEV),
                 torch.from_numpy(valid).to(DEV))["sparse_tensor"]
    lo = np.asarray(rd["point_cloud_range"][:3])
    hi = np.asarray(rd["point_cloud_range"][3:])
    vsize = (hi - lo) / np.asarray(rd["grid_size"])
    # the structure's (z, y, x) axes are (r, phi, z): its xyz are (z, phi, r)
    bb = dict(num_input_features=rd["fea_compre"],
              point_cloud_range=tuple(lo[::-1]) + tuple(hi[::-1]),
              voxel_size=tuple(vsize[::-1]),
              model_cfg=dict(SCALING_RATIO=c["ratio"]))
    cyl = build_backbone(dict(bb, type="UNetCylinder3D"))
    init_parameters(cyl, gen)
    scn = build_backbone(dict(bb, type="UNetSCN3D"))
    scn.load_state_dict(cyl.state_dict())
    cyl, scn = cyl.to(DEV).eval(), scn.to(DEV).eval()
    ws = zero_launches()
    with torch.inference_mode():
        want = scn(st)
    scn_launches = {k: w.launches for k, w in ws.items()}
    if scn_launches["rulebook_conv"] != c["convs"]:
        raise SystemExit(f"phase 3w: UNetSCN3D launched {scn_launches}")
    ws = zero_launches()
    with torch.inference_mode():
        got = cyl(st)
    launches = expect_launches("3w", "UNetCylinder3D (a forward, as "
                               "UNetSCN3D's)", ws, scn_launches)
    pairs = [(got["conv_point_features"], want["conv_point_features"])] + [
        (got["multi_scale_3d_features"][k].features,
         want["multi_scale_3d_features"][k].features)
        for k in ("x_conv1", "x_conv2", "x_conv3", "x_conv4")]
    f = got["conv_point_features"]
    nv = int(st.structure.num_voxels[0])
    if not all(torch.equal(x, y) for x, y in pairs) or \
            not torch.isfinite(f).all() or float(f[0, :nv].abs().max()) == 0:
        raise SystemExit("phase 3w: UNetCylinder3D differs from UNetSCN3D "
                         "with the same weights, or its output is not finite")
    with torch.inference_mode():
        ms = cuda_time(lambda: cyl(st), reps=5, warmup=1)
        books = cyl.structures(st.structure)
    kinds = [type(books[f"t{i}"]).__name__ for i in range(1, 5)]
    res = dict(points=len(pts), voxels=nv, grid=list(rd["grid_size"]),
               capacity=st.structure.capacity, tables=kinds, ms=ms)
    log(f"  UNetCylinder3D r={c['ratio']} on the {tuple(rd['grid_size'])} "
        f"cylindrical grid: {len(pts)} points -> {nv} voxels (capacity "
        f"{st.structure.capacity}), tables {kinds}; equal to UNetSCN3D "
        f"with the same weights bit for bit; {ms:.2f} ms a forward (CUDA "
        "events, mean of 5)")
    return dict(result=res, launches=launches,
                no_profile=True, st=st, books=books, c1=16 * c["ratio"],
                train=False)


def run_warm_cache():
    """Phase 3w's tools.warm_cache (notes above)."""
    import torch
    from lidarseg3d_torch.apis.train import example_to_device
    from lidarseg3d_torch.tools import warm_cache
    from lidarseg3d_torch.tools.test import input_shape_of
    from lidarseg3d_torch.utils.config import Config

    per = {k: KEYS_STEP[k] + KEYS_KEYS_RANK_RANK[k] for k in KEYS_STEP}
    ws = zero_launches()
    t0 = time.perf_counter()
    out = warm_cache.main([WARM])
    secs = time.perf_counter() - t0
    launches = expect_launches("3w", "warm_cache (a train and an eval step)",
                               ws, per)
    res = dict(seconds=secs, batch_size=out["batch_size"],
               build_seconds=out["build_seconds"], loss=out["train"]["loss"])
    for step in ("train", "eval"):
        res[f"{step}_s"] = out[step]["seconds"]
        res[f"{step}_peak_gib"] = out[step]["peak_bytes"] / 2 ** 30
    log(f"  warm_cache {WARM} B={out['batch_size']}: train step "
        f"{res['train_s']:.2f} s, peak {res['train_peak_gib']:.2f} GiB; eval "
        f"step {res['eval_s']:.2f} s, peak {res['eval_peak_gib']:.2f} GiB "
        f"(the peaks count what earlier phases hold); {secs:.1f} s the "
        "tool")
    cfg = Config.fromfile(WARM)
    model = out["state"].model
    ex = example_to_device(warm_cache.synthetic_example(
        cfg, out["batch_size"]), DEV)
    ex["input_shape"] = input_shape_of(cfg)
    with torch.inference_mode():
        st, books = lidar_books(model.eval(), ex)
    return dict(result=res, launches=launches, no_profile=True, st=st,
                books=books, c1=32, train=True)


def run_synthetic_e2e():
    """Phase 3w's tools.synthetic_e2e (notes above): its launches and its
    result."""
    import tempfile

    import torch
    from lidarseg3d_torch.datasets import build_dataset
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.tools import synthetic_e2e
    from lidarseg3d_torch.tools.test import input_shape_of, model_config
    from lidarseg3d_torch.utils.config import Config

    e = E2E
    argv = ["--root", tempfile.mkdtemp(prefix="synthetic_e2e_"), "--frames",
            str(e["frames"]), "--epochs", str(e["epochs"]), "--batch_size",
            str(e["batch_size"]), "--min-miou", str(e["min_miou"])]
    log(f"  tools.synthetic_e2e {' '.join(argv)}")
    ws = zero_launches()
    t0 = time.perf_counter()
    out = synthetic_e2e.main(argv)
    wall = time.perf_counter() - t0
    steps = e["epochs"] * (e["frames"] // e["batch_size"])
    per = {k: steps * RANK_STEP[k] + 2 * e["frames"] * RANK_FRAME[k]
           for k in RANK_STEP}
    launches = expect_launches(
        "3w", f"synthetic_e2e ({steps} steps, {e['frames']} frames plain and "
        "with TTA)", ws, per)
    res = dict(out["seconds"], miou=out["miou"], miou_tta=out["miou_tta"],
               frames=e["frames"], epochs=e["epochs"], steps=steps,
               seconds=wall)
    log(f"  synthetic_e2e: mIoU {out['miou']:.4f}, with TTA "
        f"{out['miou_tta']:.4f} ({e['frames']} frames, {e['epochs']} epochs "
        f"at B={e['batch_size']}, lr 0.01; held to {e['min_miou']} and to "
        f"plain - 0.02); {wall:.1f} s: fixture "
        f"{out['seconds']['fixture']:.1f}, train {out['seconds']['train']:.1f}"
        f", test {out['seconds']['test']:.1f}, TTA {out['seconds']['tta']:.1f}")
    cfg = Config.fromfile(out["config"])
    model = build_detector(model_config(cfg), device=DEV)
    ex = first_example(build_dataset(cfg.data.val.to_dict()), caps(cfg),
                       input_shape_of(cfg), DEV)
    with torch.inference_mode():
        st, books = lidar_books(model, ex)
    return dict(result=res, launches=launches, no_profile=True, st=st,
                books=books, c1=16, train=True)


def run_last_modules():
    """Phase 3w (notes above)."""
    return {"cyl_unet": run_cyl_unet(), "warm_cache": run_warm_cache(),
            "synthetic_e2e": run_synthetic_e2e()}


def check_last_module_paths(report, runs, gen):
    """Phase 4's rows of the 3w paths: from each path's own input, the
    input conv and the stride-2 conv (and, for a training path, the
    stage-1 dX and dW), every rulebook of its structures on both table
    kinds, the merge on its KeyTable stages and the pack of its first
    RankTable stage."""
    import torch
    from lidarseg3d_torch.ops import coords as co

    for name in ("cyl_unet", "warm_cache", "synthetic_e2e"):
        if name not in runs:
            continue
        r = runs[name]
        st, b, c1 = r["st"], r["books"], r["c1"]
        B, V, cin = st.features.shape
        log(f"  {name} stage voxels: " + " ".join(
            f"s{i}={b[f's{i}'].num_voxels.tolist()}/{b[f's{i}'].capacity}"
            for i in range(1, 5)))
        check_conv(report, f"{name} subm {cin}->{c1} B={B} V={V}",
                   st.features, b["subm1"], cin, c1, gen,
                   dtypes=("fp32",) if cin % 2 else ("fp32", "bf16"))
        f1 = torch.rand(B, V, c1, generator=gen).to(DEV)
        check_conv(report, f"{name} strided {c1}->{2 * c1} B={B} {V}->"
                   f"{b['s2'].capacity}", f1, b["down2"], c1, 2 * c1, gen)
        if r["train"]:
            check_conv(report, f"dX of subm {c1}->{c1} {name} B={B} V={V}",
                       f1, b["subm1"], c1, c1, gen, dx=True)
            check_dw(report, f"{name} subm {c1}->{c1} B={B} V={V}", f1,
                     b["subm1"], c1, c1, gen)
        del f1
        check_path_rulebooks(report, name, b)
        packed = False
        for i in range(1, 5):
            t = b[f"t{i}"]
            s = b[f"s{i}"]
            Z, Y, X = s.spatial_shape
            if isinstance(t, co.KeyTable):
                check_merge(report, f"{name} stage-{i} subm B={B} "
                            f"{Z * Y * (X + 2)} cells", t, subm_stream(b, i))
            elif not packed:
                act = co.activity(s.coords, s.num_voxels, s.spatial_shape)
                nce = act.shape[1] - 1
                check_pack(report, f"{name} stage-{i} B={B} {nce} cells",
                           act, nce)
                check_lookup(report, f"{name} stage-{i} B={B} {nce} cells",
                             t.packed, subm_stream(b, i))
                packed = True
        del r["st"], r["books"]
        torch.cuda.empty_cache()


def det_rulebooks(b):
    """The rulebooks of SpMiddleResNetFHD.structures (transposed): (name,
    the structure whose rows it fills, the stage whose table it reads,
    spec); the extra conv's inverse reads the table of its output, t5."""
    from lidarseg3d_torch.models.backbones.scn_det import DOWN_STAGES, EXTRA
    from lidarseg3d_torch.ops import sparse as sp

    out = [(f"subm{i}", b[f"s{i}"], i, sp.subm_spec(b[f"t{i}"], b[f"s{i}"]))
           for i in range(1, 5)]
    for i, (stride, pad) in enumerate(DOWN_STAGES, start=2):
        lo, hi = b[f"s{i}"], b[f"s{i - 1}"]
        out.append((f"down{i}", lo, i - 1,
                    sp.strided_spec(b[f"t{i - 1}"], hi, 3, stride, pad)))
        out.append((f"inv{i}", hi, i,
                    sp.inverse_spec(b[f"t{i}"], lo, 3, stride, pad)))
    out.append(("down5", b["s5"], 4, sp.strided_spec(b["t4"], b["s4"],
                                                     **EXTRA)))
    out.append(("inv5", b["s4"], 5, sp.inverse_spec(b["t5"], b["s5"],
                                                    **EXTRA)))
    return out


def check_det_paths(report, runs, gen):
    """Phase 4's rows of the detection paths (3r, 3s; 3u's step, whose
    first stage has det-wy-train's shapes, when 3s did not run): from a
    frame of det-nu-eval (120,000 voxels, 10 sweeps) and a B=4 batch of
    det-wy-train (4 x 150,000 rows), the input conv 5->16 (fp32), the stage-1 subm
    16->16, the stride-2 conv 16->32, stage 4's strided conv 64->128
    (padding (0, 1, 1)) and the extra (3, 1, 1) stride-(2, 1, 1) conv
    128->128; at B=4 the stage-1 dX 16->16 and dW (600,000 rows) and the
    extra conv's dX under its inverse rulebook; all 12 rulebooks of the
    chain on both table kinds, the merge on the stage-1 and stage-2
    KeyTables, and the pack and fused lookup on the stage-3 RankTable."""
    import torch
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.ops import sparse as sp

    # the two-stage step's first stage has det-wy-train's shapes
    names = ("det_nu_eval", "det_wy_train" if "det_wy_train" in runs
             else "tsd_train")
    for name in names:
        if name not in runs:
            continue
        m, ex = runs[name]["model"], runs[name]["ex0"]
        m = getattr(m, "single_det", m)
        with torch.no_grad():
            feats = m.reader_mod(ex["voxels"], ex["num_points"],
                                 ex["coordinates"])
            s1 = sp.build_structure(ex["coordinates"], ex["num_voxels"],
                                    ex["input_shape"])
            b = m.backbone_mod.structures(s1, transposed=True)
            b["t5"] = sp.dense_table(b["s5"])
        B, V = feats.shape[:2]
        kinds = [type(b[f"t{i}"]).__name__ for i in range(1, 6)]
        log(f"  {name} tables {kinds}; stage voxels: " + " ".join(
            f"s{i}={b[f's{i}'].num_voxels.tolist()}/{b[f's{i}'].capacity}"
            for i in range(1, 6)))
        if kinds[:4] != ["KeyTable", "KeyTable", "RankTable", "RankTable"]:
            raise SystemExit(f"phase 4 {name}: table kinds {kinds}")
        check_conv(report, f"{name} subm 5->16 B={B} V={V}", feats,
                   b["subm1"], 5, 16, gen, dtypes=("fp32",))
        f16 = torch.rand(B, V, 16, generator=gen).to(DEV)
        check_conv(report, f"{name} subm 16->16 B={B} V={V}", f16,
                   b["subm1"], 16, 16, gen)
        check_conv(report, f"{name} strided 16->32 B={B} {V}->"
                   f"{b['s2'].capacity}", f16, b["down2"], 16, 32, gen)
        V3, V4, V5 = (b[f"s{i}"].capacity for i in (3, 4, 5))
        f64 = torch.rand(B, V3, 64, generator=gen).to(DEV)
        check_conv(report, f"{name} strided (0,1,1) 64->128 B={B} "
                   f"{V3}->{V4}", f64, b["down4"], 64, 128, gen)
        f128 = torch.rand(B, V4, 128, generator=gen).to(DEV)
        check_conv(report, f"{name} extra (3,1,1)/(2,1,1) 128->128 B={B} "
                   f"{V4}->{V5}", f128, b["down5"], 128, 128, gen)
        if name != "det_nu_eval":
            check_conv(report, f"dX of subm 16->16 {name} B={B} V={V}",
                       f16, b["subm1"], 16, 16, gen, dx=True)
            check_dw(report, f"{name} subm 16->16 B={B} V={V}", f16,
                     b["subm1"], 16, 16, gen)
            g5 = torch.rand(B, V5, 128, generator=gen).to(DEV)
            check_conv(report, f"dX of extra (3,1,1) {name} B={B} "
                       f"{V5}->{V4}", g5, b["inv5"], 128, 128, gen, dx=True)
            del g5
        del f16, f64, f128
        check_path_rulebooks(report, name, b, det_rulebooks(b))
        for i in (1, 2):
            Z, Y, X = b[f"s{i}"].spatial_shape
            check_merge(report, f"{name} stage-{i} subm B={B} "
                        f"{Z * Y * (X + 2)} cells", b[f"t{i}"],
                        subm_stream(b, i))
        s3 = b["s3"]
        act3 = co.activity(s3.coords, s3.num_voxels, s3.spatial_shape)
        nce3 = act3.shape[1] - 1
        check_pack(report, f"{name} stage-3 B={B} {nce3} cells", act3, nce3)
        check_lookup(report, f"{name} stage-3 B={B} {nce3} cells",
                     b["t3"].packed, subm_stream(b, 3))
        del b, feats, act3
        torch.cuda.empty_cache()


PHASES = ("3", "3b", "3c", "3d", "3e", "3f", "3g", "3h", "3i", "3j", "3k",
          "3l", "3m", "3n", "3o", "3p", "3q", "3r", "3s", "3t", "3u", "3v",
          "3w", "4", "5")


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Drive the port's main paths "
                                "on one CUDA card (see the module docstring)")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated phases to run after 1 and 2 "
                   f"(default: all of {','.join(PHASES)}); phases 4 and 5 "
                   "cover the paths that ran")
    args = p.parse_args(argv)
    args.phases = [x.strip() for x in args.phases.split(",") if x.strip()]
    bad = set(args.phases) - set(PHASES)
    if bad:
        p.error(f"unknown phases {sorted(bad)}")
    return args


def main(argv=None):
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)\n")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from lidarseg3d_torch.ops import cuda_build

    t_start = time.perf_counter()

    def phase(text):
        """A phase's header, with the seconds since the script started."""
        log(f"[{time.perf_counter() - t_start:.1f} s] phase {text}")

    phase("1: card")
    log(f"  {card}")
    log(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phase("2: build")
    secs = cuda_build.build()
    log(f"  built {sorted(cuda_build.SOURCES)} (nvcc) and "
        f"{sorted(cuda_build.HOST_SOURCES)} (cc) in {secs:.1f} s")
    for name, text in sorted(cuda_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    paths, runs = main_paths(), {}
    want = set(args.phases)
    for ph, name in (("3", "semkitti"), ("3b", "semnusc")):
        if ph in want:
            phase(f"{ph}: main path {name}")
            runs[name] = run_path(name, paths[name])
    steps = [
        ("3c", "main path train", lambda: {"train": run_train()}),
        ("3d", "main path eval (published semkitti config)",
         lambda: {"eval": run_eval_path()}),
        ("3e", "main path train entry (published semkitti config, B=2, "
         "the pretrained HRNet imported)",
         lambda: {"train_entry": run_train_entry()}),
        ("3f", "main path eval-nu (published nuScenes config)",
         lambda: {"eval_nu": run_eval_path(EVAL_NU, "3f")}),
        ("3g", "main path train-nu (published nuScenes config, B=3, shm "
         "loader)", lambda: {"train_nu": run_train_entry(TRAIN_NU, EVAL_NU,
                                                         "3g")}),
        ("3h", "main path sdseg-eval (published SDSeg3D semkitti config, "
         "then its _tta config with --tta)",
         lambda: {"sd_eval": run_eval_path(EVAL_SD, "3h"),
                  "sd_eval_tta": run_eval_path(EVAL_SD_TTA, "3h")}),
        ("3i", "main path sdseg-train (published SDSeg3D semkitti config, "
         "B=4)", lambda: {"sd_train": run_train_entry(TRAIN_SD, EVAL_SD,
                                                      "3i")}),
        ("3j", "main path sdseg-nu-tta (published SDSeg3D nuScenes _tta "
         "config with --tta)",
         lambda: {"sd_nu_tta": run_eval_path(EVAL_SD_NU, "3j")}),
        ("3k", "main path cyl-eval (published Cylinder3D nuScenes config, "
         "then its _v2p config)",
         lambda: {"cyl_eval": run_eval_path(EVAL_CYL, "3k"),
                  "v2p_eval": run_eval_path(EVAL_V2P, "3k")}),
        ("3l", "main path cyl-train (published Cylinder3D nuScenes config, "
         "B=2, then its _v2p config)",
         lambda: {"cyl_train": run_train_entry(TRAIN_CYL, EVAL_CYL, "3l"),
                  "v2p_train": run_train_entry(TRAIN_V2P, EVAL_V2P, "3l")}),
        ("3m", "main path polar (published PolarNet nuScenes config: eval, "
         "then trained at B=2)",
         lambda: {"polar_eval": run_eval_path(EVAL_POLAR, "3m"),
                  "polar_train": run_train_entry(TRAIN_POLAR, EVAL_POLAR,
                                                 "3m")}),
        ("3n", "multi-process training and evaluation (two ranks sharing "
         "the card over gloo; one NCCL rank from torchrun's variables)",
         lambda: {"ddp": run_ddp()}),
        ("3o", "main path waymo-eval (published SemanticWaymo MSeg3D "
         "config, then its lidar baseline)",
         lambda: {"waymo_eval": run_eval_path(EVAL_WAYMO, "3o"),
                  "waymo_base_eval": run_eval_path(EVAL_WAYMO_BASE, "3o")}),
        ("3p", "main path waymo-train (both SemanticWaymo configs at B=2, "
         "the pretrained HRNet imported)",
         lambda: {"waymo_train": run_train_entry(TRAIN_WAYMO, EVAL_WAYMO,
                                                 "3p"),
                  "waymo_base_train": run_train_entry(
                      TRAIN_WAYMO_BASE, EVAL_WAYMO_BASE, "3p")}),
        ("3q", "bf16 image branch in training, and HRNet-w48",
         run_bf16_w48),
        ("3r", "main path det-nu (published nuScenes CenterPoint VoxelNet "
         "configs: eval with rotated and circle NMS, trained at B=4)",
         run_det_nu),
        ("3s", "main path det-wy (published Waymo CenterPoint VoxelNet "
         "config through both tools, B=4 with the db_sampler; the two-sweep "
         "velocity config evaluated)", run_det_wy),
        ("3t", "main path det-pp (published Waymo PointPillars config "
         "through both tools: no kernel of the port)", run_det_pp),
        ("3u", "main path tsd (published two-stage Waymo CenterPoint config "
         "through tools.test, then tools.train at B=4 with the first stage "
         "frozen)", run_tsd),
        ("3v", "the tools: nuScenes and Waymo tracking, single_inference, "
         "simple_inference_waymo, the C voxelizer",
         lambda: run_frame_tools(runs)),
        ("3w", "the last modules: UNetCylinder3D on the Cylinder3D grid, "
         "tools.warm_cache (published semkitti config), "
         "tools.synthetic_e2e (cut to 6 frames, 12 epochs)",
         run_last_modules),
    ]
    for ph, text, fn in steps:
        if ph in want:
            phase(f"{ph}: {text}")
            runs.update(fn())
        if ph == "3c" and ph in want:
            small_train_check()
    if "4" not in want:
        report = []
    else:
        phase("4: kernels against their plain versions")
        report = kernel_checks(runs)
        for row in report:
            k = row["name"].split("[")[0]
            by_path = {n: r["launches"][k] for n, r in runs.items()}
            row["launches"] = sum(by_path.values())
            row["launches_by_path"] = by_path
    if "5" in want:
        phase("5: profile of one scan per inference path, one train step, "
              "and each inference path's structures+rulebooks build")
        for name, r in runs.items():
            if "model" not in r or r.get("no_profile"):
                # 3n ran in processes of its own; of 3r-3u, det_nu_eval,
                # det_wy_train, tsd_eval and tsd_train are profiled
                continue
            log(f"  {name}:")
            t_path = time.perf_counter()
            training = "step" in r
            det = r.get("no_structures", False)
            if training:
                fn = lambda r=r: r["step"](r["state"], r["ex0"])  # noqa: E731
            else:
                def fn(r=r, det=det):
                    # a detector builds its inverse rulebooks only while
                    # autograd records, so its frame runs as tools.test
                    # runs it
                    with torch.inference_mode(det):
                        ret, bat = r["model"](r["ex0"])
                        r["model"].predict(ret, bat)
            share, per_name = profile_call(
                fn, "train step" if training else "scan",
                host_top=12 if det else 0)
            log("  its conv and dW kernels (device time, launches):")
            r["result"]["device_busy_share"] = share
            r["result"]["conv_kernels"] = conv_kernel_sums(per_name)
            if det:
                r["result"]["kernels_by_name"] = {
                    k: [us / 1e3, n] for k, (us, n) in sorted(
                        per_name.items(), key=lambda kv: -kv[1][0])[:12]}
            elif name in BUILD_KERNELS_BEFORE:
                # the build's profile where a count before the fused
                # rulebook kernels exists to set it beside
                log(f"  {name}, structures+rulebooks of one scan:")
                r["result"]["structures"] = profile_structures(name, r)
            log(f"  ({time.perf_counter() - t_path:.1f} s)")
    log(json.dumps({"main_path": {n: r["result"] for n, r in runs.items()},
                    "phases": ["1", "2"] + args.phases,
                    "seconds": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
