"""Drive the PyTorch port's 3DMatch registration (f32 and the bf16 fast path)
and training (f32 and bf16), its 4DMatch registration and bf16 training, its
2D-3D registration and training
(with and without the DINOv2 / DepthAnything towers), its CLI, the 3D,
2D-3D and 4DMatch synthetic training stories' trained weights, its
data-parallel train step, two model variants, the kernels' whole shape
range (any kernel-point count, any head width), the library surface
(neighbours, sampling, point features, consistency, deformation, EPro-PnP,
rendering) and the model zoo (a GeoTransformer-shaped registration at its
published width, the other zoo families, the encoders) on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels (nvcc, sm_90a) from csrc/ and prints the
     build seconds and ptxas' register/shared-memory report;
  3. holds each kernel against its plain PyTorch version on the card, at the
     main path's shapes (KPConv: every distinct layer of the encoder, on the
     activations the encoder really feeds it; attention: the self shape [2B]
     and cross shape [B] with the batch's key masks), and times the kernel,
     the plain version and, for attention, PyTorch's
     scaled_dot_product_attention as a yardstick (the port never calls it);
     then, at the same shapes, the gradients through each kernel's autograd
     Function (forward: the kernel; backward: the plain recompute) against
     plain autograd, with the backward's time; then the same at the 4DMatch
     shapes (KPConv per layer of preset_4dmatch's encoder, attention at head
     width 132, a self call per side, with its gradients) on the 4DMatch
     phase's data;
  4. runs the DDIM path (``register``) at full width (preset_3dmatch: 432-dim,
     4 heads, 17-block KPFCN, 704 coarse tokens per side from 4096-point
     clouds, 20 DDIM steps, RANSAC with 8192 hypotheses) with random weights
     from a seed, at condition gate 0 and gate 40: one warm-up and three timed
     runs each (pairs/s from the median), the kernels' launches asserted for
     every run (KPConv by the route its C entry reports: the tuned kernel at
     10 layers, the any-shape kernel at the first, ``ENCODE_ROUTES``) and
     the outputs checked;
  5. runs one pair of the DDIM path through the same port on the CPU (plain
     versions) and holds the card's result against it, and holds RANSAC on the
     card and on the CPU against a known pose (pair 0's coarse points, 40%
     outliers);
  6. runs ``backbone_forward`` (gate 0) on the same 4 pairs: one warm-up and
     three timed runs, launches asserted, pair 0 held against the CPU;
  7. trains at full width (preset_3dmatch(train=True): gate 200, the
     reference SGD) with the ``Trainer``: one epoch of a warm-up and five
     timed steps on the 4 pairs into a temporary directory, launches, the
     loss and the gradients' finiteness asserted per step, then ``resume``
     from its checkpoint; one more backward checks that every trained
     parameter but the positioning layer's matcher gets a finite gradient;
  8. takes one train step of one pair on the card and on the CPU from the
     same weights and draws and compares the loss, every gradient and the
     parameters after the SGD step;
 8b. the bf16 fast path (compute_dtype bfloat16, precision default, as
     configs/test/3dmatch_fast.yaml sets them): each kernel's bf16 instance
     against its plain bf16 version (KPConv at the 11 layers of a bf16 encode
     on the activations it feeds them, attention at the 3DMatch self and
     cross shapes, D = 108, and at the 4DMatch shapes, D = 132), timed beside
     the plain version and, for attention, SDPA in bf16, and at the edges
     of their tilings (attention at 70 x 45, 1 x 768, 768 x 1, one valid
     key, a key range past the kept logits; KPConv at K 1 and 40, a short
     tile, the kernel-point split on and off, Cin 32 and 512); the bf16 DDIM path
     at full width, gate 0 and 40, one warm-up and three timed runs (pairs/s
     beside the f32 path's of phase 4, peak memory), 11 bf16 KPConv and 180
     bf16 attention launches asserted per run and no f32 kernel launch;
     pair 0 against the port's CPU run in bf16 (confidences, poses, the
     union mask up to near-ties; the card's bf16-vs-f32 gap printed; at
     gate 40 pair 0 run again keeping the CPU's top-k choices); and
     ``diffreg_tpu_torch.main`` on configs/test/3dmatch_fast.yaml with --demo;
     before the DDIM, at the same shapes, the gradients through each bf16
     instance's autograd Function (forward: the kernel; backward: the plain
     bf16 recompute) against plain bf16 autograd, with the backward's time;
 8c. bf16 training (compute_dtype bfloat16, precision default, mode train):
     the Trainer at phase 7's full width (gate 200, the reference SGD) for a
     warm-up and five timed steps with resume, 11 bf16 KPConv and 15 bf16
     attention launches and no f32 kernel launch asserted per step, its
     phases, steps/s and peak memory beside phase 7's f32 numbers; one bf16
     train step of pair 0 on the card and on the CPU (the loss, every
     gradient, the SGD update; the card's f32 step from the same weights and
     draws printed beside); the Trainer at preset_4dmatch's widths on the
     4DMatch phase's pairs (704 x 768 tokens, 20 launches of the D = 132 bf16
     instance a step); ``diffreg_tpu_torch.main --mode train --demo`` on
     copies of configs/train/3dmatch.yaml and 4dmatch.yaml with the two keys
     (one epoch, a checkpoint each), then configs/test/3dmatch_fast.yaml on
     the 3DMatch checkpoint (restored, IR, FMR, RR);
 8d. takes one train step of 4DMatch pair 0 (the 4DMatch phase's pairs, gate
     40, the 4DMatch loss) on the card and on the CPU, in f32 (phase 8's
     limits) and in bf16 (TRAIN_BF16_LIMITS_4D, the card's f32 step printed
     beside);
  9. runs the 4DMatch path at full width through FourDMatchTester
     (preset_4dmatch: 528-dim, 4 heads of 132, gate 40, stochastic DDIM with
     20 steps) on 4 deformable pairs of 4096 points at scene scale 1/3, at the
     spec calibrated from such pairs as main.py calibrates (704 source and 768
     target tokens, so each self layer is one call per side), with the DDIM
     start, the noise and the metric points from seeded generators: one
     warm-up and three timed runs (pairs/s from the median), 11 KPConv and
     the spec's attention launches (12 a DDIM step) asserted per forward,
     matches, IR and NFMR printed;
 10. runs pair 0 of that path on the CPU with the same weights and draws and
     holds the sigmoid confidences, the soft-Procrustes pose, the thr-mutual
     match mask, IR and NFMR against the card's;
 11. runs the entry point ``diffreg_tpu_torch.main`` in a temporary working
     directory: configs/test/4dmatch.yaml with --demo at the protocol's
     threshold 0.55; the same config on phase 9's pairs written as an
     on-disk 4DMatch split with a checkpoint of random weights (main's own
     calibration from the YAML's pyramid, the loader, the restore, NFMR on
     the metric_index points; matches asserted at MATCH_THR_4D);
     configs/test/3dmatch.yaml with --demo; and configs/train/4dmatch.yaml
     with --demo --mode train (its max_epoch cut to 1: two steps and a
     checkpoint), each with its summary and launches checked;
 12. writes 4 RGB-D Scenes V2-like pairs as an on-disk split (16-bit depth
     and 8-bit colour PNGs of a smooth scene on a 480 x 640 Kinect sensor,
     clouds of 30,000 points that partly overlap the view, intrinsics,
     metadata), reads them back through the port's reader, calibrates and
     crops them to 472 x 624 (4602 image tokens) as main.py does, and holds
     both kernels against their plain versions at the 2D-3D shapes: KPConv at
     each distinct layer of the point backbone on the activations it really
     feeds them (K = 64 at level 0), attention at head width 64 in the
     fusion's four shapes with the batch's masks and at a node count that is
     not a multiple of 32, with SDPA's time; the gradients through each
     kernel's Function at the widest KPConv layer and at all four attention
     shapes, with the backward's time;
 13. runs the 2D-3D path at full width (configs/test/rgbdv2.yaml, SAMPLE_STEP
     50, random weights from seed 0) through TwoDThreeDTester: one warm-up
     and three timed runs (pairs/s from the median), 8 KPConv (by route:
     ``BACKBONE_2D3D_ROUTES``, the any-shape kernel at the level-0 trio) and
     612 attention launches asserted per forward, where the time goes (encode,
     partition, one fusion pass, the DDIM steps, fine matching and PnP);
 14. runs pair 0 on the CPU at 10 DDIM steps with the same weights and draws
     (the matchers sharpened) and holds the Sinkhorn confidences, the top-1
     mask (up to near-ties) and the fine matches on the same coarse
     correspondences against the card's, and in backbone mode the coarse
     matcher's confidences and mask (up to near-ties, at most 1% of its
     entries, with at least half of the real node rows free of a near-tie:
     the DDIM's mask is held only up to near-ties, which cover its rows);
     holds PnP-RANSAC on the card and the CPU against pair 0's known pose
     (40% outlier pixels);
 15. runs ``diffreg_tpu_torch.main`` on configs/test/rgbdv2.yaml and
     7scenes.yaml with --demo, and on the split of phase 12 with a checkpoint
     of random weights (calibration, the PNG reader, the restore, the npz
     cache, eval_from_cache), each with its summary and launches checked;
 16. trains the 2D-3D model at configs/train/rgbdv2.yaml widths (batch 1, Adam
     at lr 1e-4; the circle, focal and fine losses) on a train subset written
     beside the test split (4 more pairs of the same size, read with the
     reader's augmentation): the Trainer for a warm-up and five timed steps
     (forward, backward and optimizer seconds, steps/s, peak memory; 8 KPConv
     and 24 attention launches and finite loss terms and gradients asserted
     per step), then ``resume``; one train step of pair 0 on the card and on
     the CPU from the same weights and draws (the loss, every gradient; the
     draw chosen so that soft Procrustes' top-k cut on the noisy matrix lies
     in a gap wider than the two devices' difference there); and
     ``diffreg_tpu_torch.main --mode train`` on configs/train/rgbdv2.yaml
     with that split (one epoch), its loss terms and checkpoint checked;
 17. runs the published model (configs/test/rgbdv2_dino.yaml: DINOv2 tokens
     fused, DepthAnything centres, stride 14): builds ViT-L/14 DINOv2 and
     DepthAnything with weights from a seed and holds the card's tokens and
     depth on pair 0's 476 x 630 image against the CPU's, with each tower's
     ms an image and peak memory; reads the split at stride 14 (34 x 45 =
     1530 image tokens) with each pair's tower outputs from the card; holds
     KPConv per point-backbone layer and attention in the fusion's four
     shapes (head width 64) against their plain versions; runs the path
     through TwoDThreeDTester (SAMPLE_STEP 50; one warm-up and three timed
     runs, 8 KPConv and 612 attention launches asserted per forward, ms a
     DDIM step, peak memory), pair 0 on the CPU against the card (the 2D-3D
     limits of phase 14) and PnP; and ``diffreg_tpu_torch.main`` on a copy of
     the YAML whose ``towers`` are the seeded towers' state_dicts, on the
     split with a checkpoint of random weights; then trains the dino model on
     phase 16's train subset with the card's tower outputs: the Trainer for
     a warm-up and five timed steps (steps/s, peak memory) and one step of
     pair 0 card against CPU at phase 16's limits;
 18. the synthetic training story (tools/train_synthetic_port.py): both bf16
     kernels at its shapes (8 pairs of 512 tokens, 4 heads of 24, KPConv at
     K 16 over its 11 layers) against their plain bf16 versions, forward and
     gradient; then the committed trained weights
     (snapshot/train-synthetic-torch/params.npz): the DDIM + RANSAC eval of
     the 32 test pairs (launches counted, success at least 0.30, beside
     metrics.json's) and test pair 0 card against CPU in bf16 (confidences,
     the real rows free of a near-tie, the mask on those rows);
 19. the 2D-3D synthetic training story (tools/train_synthetic_2d3d_port.py):
     both f32 kernels at its shapes (4 pairs, 1024 points a level at K 16,
     88 image tokens, 4 heads of 32 in instance 64) against their plain
     versions, forward and gradient, with SDPA's time; then the committed
     trained weights (snapshot/train-synthetic-2d3d-torch/params.npz): the
     reference protocol's eval of the 16 test pairs (launches counted; RR, IR
     and FMR within one pair's worth of metrics.json's) and test pair 0 card
     against CPU at 10 DDIM steps with the same start (its top-k cut gaps
     printed) and PnP draws: the DDIM output's confidences, the real node
     rows free of a near-tie, the mask on those rows, the fine matches;
 20. the 4DMatch synthetic training story (tools/train_synthetic_4d_port.py):
     both bf16 kernels at its shapes (8 deformable pairs of 512 tokens a
     side, 4 heads of 24, KPConv at K 16 over its 11 layers) against their
     plain bf16 versions, forward and gradient; then the committed trained
     weights (snapshot/train-synthetic-4d-torch/params.npz): the 4DMatch
     tester protocol's eval of the 32 test pairs (the stochastic DDIM at gate
     40 from the tool's fixed draws, the thr-mutual mask at the protocol's
     0.55; launches counted, IR and NFMR within 1e-2 of metrics.json's) and
     test pair 0 at batch 1 card against CPU in bf16 and in f32 at 0.55, from
     the first draw whose step conditions clear the gate and whose top-k cut
     gaps clear CUT_GAP_MIN: the sigmoid confidences, the pose, at least one
     match, the real rows free of a near-tie and of the threshold, the
     thr-mutual mask on those rows, IR and NFMR;
 21. data parallel (``diffreg_tpu_torch.parallel``) on the card, at phase 7's
     full width (gate 200, the reference SGD): in a one-process NCCL group
     the data-parallel step on the 4 pairs must equal the plain step bit for
     bit (the loss, every gradient, the parameters after the update; both
     under deterministic algorithms, and the plain step twice, so that it
     repeats itself); then two processes share the card over gloo, a pair
     each, and their step must match the plain step on both pairs at phase
     8's f32 limits, with the same parameters in both processes; launches
     counted in every process;
 22. the model variants (``VARIANTS``): (a) each KPConv mode instance the
     variants add (constant and gaussian influence with sum aggregation;
     linear, constant and gaussian with "closest"), f32 and bf16, against
     its plain version at a 3DMatch encode's 11 layers (timed, with its
     bound; under "closest" a row beyond the limit is excused only at a
     near-tie between two kernel points) and at the tilings' edges, with
     the gradients through its autograd Function; (b) variant A (the
     coarsest level's three blocks deformable and modulated, gaussian
     influence, the "verticals" dispositions, batch norm off, sinusoidal PE,
     dual-softmax matching) and (c) variant B (constant influence, "closest"
     aggregation, entangled) of preset_3dmatch at full width on the 4 pairs:
     the DDIM path at gate 0 and 40 with every KPConv launch in the
     variant's mode, pair 0 card against CPU (the DDIM at gate 0 by its
     confidences, ``VARIANT_CONF_REL_TOL`` from tools/spread_port_variants.py;
     the DDIM at gate 40 by its confidences and pose, the card keeping the
     CPU's top-k choices in soft Procrustes, each of its own that differs
     lying at the cut; backbone_forward by its confidences, mask and pose),
     the discrete choices that flip card against CPU (closest's kernel
     point as the kernel picks it, the deformable in-range cut; each must be
     a near-tie), the fitting regularizer card against CPU, one train step
     at gate 200 card against CPU at phase 8's limits (variant A's with the
     CPU's top-k choices kept), and one bf16 DDIM; (d)
     ``diffreg_tpu_torch.main`` on configs/test/3dmatch.yaml with variant A's
     keys, --demo;
 23. the shape range (``run_shape_range``): (a) both KPConv kernels, f32
     and bf16, at every kernel-point count of SHAPE_POINTS (any P but 15
     takes the any-P tensor-core kernel at the wide layers and the any-shape
     kernel at the others) against their plain versions at a 3DMatch encode's 11
     layers and the 2D-3D level-0 shapes, linear/sum at every P,
     gaussian/sum and linear/closest at P = 17 and 24 (a bf16 row beyond the
     limit excused only where one rounding flip of a term explains it), timed,
     with the gradients through both Functions at P = 24; (b) the attention
     kernel, f32 and bf16, at every head width of SHAPE_HEAD_WIDTHS (the any-D
     route where D is not a multiple of 4 or above the tuned instances: its
     tensor-core branch, and its CUDA-core branch for the widest), D = 256 at
     the 2D-3D image self shape, calls on q, k and v offset by one element
     (4- and 2-byte aligned rows), and one call with B * H past the grid's
     65,535 rows, timed beside the plain version and SDPA, with gradients at D
     = 54 and 528; (c) configuration C (configs/test/3dmatch.yaml with 24
     kernel points and 8 heads of 54) on the 4 pairs: the DDIM at gate 0 and 40
     through the new routes, pair 0 card against CPU (gate 0; gate 40 with the
     CPU's top-k choices kept), backbone_forward at phase 6's limits, one
     train step at phase 8's limits, one bf16 DDIM at phase 8b's; (d)
     configuration W (2 heads of 216): the DDIM at gate 0 in f32 and bf16, pair
     0 card against CPU; (e) ``diffreg_tpu_torch.main`` --demo on C's YAML and
     on configs/test/4dmatch.yaml with one head of 528; every part's launches
     counted by route (KPConv by kernel-point count and kernel, attention by
     instance and any-D branch), C's ten wide KPConv layers and C's and W's
     attention asserted on the tensor-core routes; (f) the any-shape KPConv
     kernel, f32 and bf16, at ANY_SHAPE_EDGES (Cin, Cout, K and P on each side
     of its tilings, the other modes, views offset by one element) against
     its plain version at phase 1's limits, every launch asserted on its
     route, the 4DMatch CLI's wide K = 58 layer timed, the gradients through
     both Functions at a narrow layer;
 24. the library surface (``run_library``, no CUDA kernel: plain PyTorch on
     the card, each part held against the same call on the CPU on the same
     inputs and draws, and timed on both): (a) radius_neighbors and knn on the
     3DMatch phase's level 0 of pair 0 and on the 2D-3D phase's (30,000
     points, K 64), indices identical but for ties or straddles of the radius
     within rounding, the differences from the native C++ search counted;
     (b) farthest_point_sampling of 1,024 of those 30,000 points, indices
     identical; (c) estimate_normals (k 50), build_local_reference_frame and
     local_ppf on a 4,096-point cloud; (d) spatial_consistency and
     leading_eigenvector on phase 4's pair-0 correspondences; (e) the
     deformation graph of phase 9's pair-0 source (host C++), then
     non_rigid_icp_gauss_newton (5 iterations) and non_rigid_icp_adam (500)
     from correspondences under its GT flow, the warped source's mean error
     printed; (f) EPro-PnP's monte_carlo_forward, 4 and 6 DoF, 512 samples in
     4 iterations on 4 pairs of 4,096 correspondences from the 2D-3D clouds
     and cameras under a known pose with 10% outliers, the pose held against
     it (PNP_POSE_TOL); (g) sample_pdf and volume_render on 4,096 rays of 64
     bins, batch_to_pack and pack_to_batch on the 2D-3D node batch; at most
     60 s (``python3 chip_smoke.py --library`` runs this phase alone, on
     inputs it makes itself);
 25. the model zoo (``run_zoo``; ``python3 chip_smoke.py --zoo`` builds the
     kernels and runs this phase alone): (a) GeoTransformer's forward composed
     of the zoo's pieces at its published 3DMatch width (``ZOO_FPN``,
     ``ZOO_GT``) on the 3DMatch phase's 4 pairs: KPConvFPN (11 KPConv
     launches through csrc/kpconv.cu), the geometric transformer on level 3
     (its 6 cross-block attention calls through csrc/attention.cu, the self
     blocks' relative-position attention in plain PyTorch), 256 superpoint
     correspondences, patches of 64 level-1 points, Sinkhorn with a dustbin
     and local-to-global registration, every stage timed and the launches
     counted; pair 0 card against CPU stage by stage on the CPU's inputs
     (``ZOO_LIMITS``; the transformer also on superpoints rounded to a grid,
     whose self-pair distances are exact); LGR on a known pose at the full
     shapes; the lite transformer; both kernels at the zoo's shapes against
     their plain versions (with SDPA's time, and the relative-position self
     layer beside SDPA with an additive float mask); (b) PointNet++ set
     abstraction and a PointTransformer block on 4,096 points, FoldingNet,
     Vector Neurons, Predator's GCN on 512 nodes a side, URR's
     correspondences, the renderer and ResUNet 18 at 480 x 640; (c) VGG19-bn
     at 480 x 640 and CNNandDinov2 with ViT-S/14; (d) grid_subsample against
     grid_subsample_np and the other small library functions; each held
     card against CPU (a neighbourhood cut at a near-tie excused and counted);
 26. prints the kernels' JSON line, and as its last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Any failure raises and exits nonzero. Without CUDA, or outside a checkout of
the repository, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

BATCH_PAIRS = 4
N_POINTS = 4096
STEPS = 20
HYPOTHESES = 8192
GATES = (0.0, 40.0)
TIMED_RUNS = 3
# 4DMatch phase: deformable pairs at scene scale 1/3 (the 0.01 voxel of
# configs/test/4dmatch.yaml gives the 3DMatch phase's grid), flow 0.1 after
# scaling (tools/train_synthetic_4d.py:49-50); metric points per pair for NFMR
SCALE_4D = 1.0 / 3.0
FLOW_AMP_4D = 0.3
METRIC_POINTS = 2048
# 2D-3D phases: RGB-D Scenes V2-like pairs on a Kinect-sized sensor (the
# reader crops 476 x 630, main.py 472 x 624: 59 x 78 = 4602 image tokens), a
# cloud of 30,000 points that partly overlaps the view, configs/test/rgbdv2.yaml
SENSOR_HW = (480, 640)
CLOUD_POINTS = 30000
KINECT_F = 570.3
STEPS_2D3D_CPU = 10        # pair 0 on the CPU at configs/test/7scenes.yaml's count
PNP_HYPOTHESES = 8192
# Random weights: the image and the cloud encoders are independent random
# networks, so a pixel's and a point's cosine similarity is about N(0, 1/128)
# and the mutual top-2 sit near 0.2; the protocol's 0.75 extracts nothing.
# The tester phase and pair 0 extract at 0 (the CLI runs keep the config's)
FINE_THR_2D3D = 0.0
# Pair 0, card vs CPU. Plain random weights leave the final Sinkhorn
# confidences near-uniform (all ~1.6e-4, every row's best two within 2e-8:
# the top-1 union mask holds 1.8M tied entries a pair); this phase scales
# both matchers' projections by SHARPEN_2D3D, which spreads them (~8k
# entries). Each entry where the two masks differ must lie in a row or
# column whose best two CPU confidences are within twice the confidence
# limit. With random weights the DDIM's final confidences are flat even so
# (no real node row free of a near-tie), so this DDIM mask check excuses every
# differing entry: here the DDIM output is held by its confidence limit only,
# and its tie-free share is printed. Phase 19 holds the DDIM output's tie-free
# share and mask cap on the 2D-3D story's trained weights. Here the
# tie-free share and the cap hold the coarse matcher, not the DDIM output:
# on the same pair and weights (backbone mode) at least TIE_FREE_ROWS_MIN of
# the real node rows must be free of a near-tie, and at most
# MASK_DIFFER_SHARE of its mask may differ. The fine matches are held on the same coarse
# correspondences (the card's): the card's against the CPU's fine matching
# of the CPU's features.
SHARPEN_2D3D = 8.0
CONF_2D3D_ABS_TOL = 5e-7   # Sinkhorn confidences, valid entries (measured 1.2e-7 DDIM,
#                            3.6e-8 coarse matcher)
FINE_2D3D_AGREEMENT = 0.99  # fine correspondences: shared share of the union (measured 1.0)
PNP_POSE_TOL = 1e-3        # PnP on a known pose (measured 9.6e-6 card, 1.2e-4 CPU)
TIE_FREE_ROWS_MIN = 0.5    # (measured 0.989 of 750 rows, coarse matcher)
MASK_DIFFER_SHARE = 0.01   # plus 2: the CPU test's cap (measured 0 of 5322 entries differ)
# the published model's towers (ViT-L/14, weights from a seed), card against
# CPU: plain f32 (TF32 off) in both, in different orders of summation
TOWER_REL_TOL = 1e-4       # of max |CPU output| (measured 2.0e-6 tokens, 1.3e-5 depth)
# 2D-3D training (configs/train/rgbdv2.yaml, batch 1, Adam lr 1e-4): a step runs
# the coarse and the denoising fusion passes (12 attention calls each) and one
# point-backbone pass (8 KPConv calls); the card-vs-CPU step keeps the 3D
# step's limits (LOSS_REL_TOL, GRAD_*_TOL below)
TIMED_STEPS_2D3D = 5       # after one warm-up step
TRAIN_ATTENTION_2D3D = 24
LOSS_TERMS_2D3D = ("circle", "gt_hat", "fine", "fine_recall", "focal")
# softmax is unchanged by a bias added to every key: those gradients are
# rounding, held apart from the others
KEY_BIAS = "k_token_layer.bias"
KEY_BIAS_TOL = 1e-6
# the dino model's mono-depth scale at its initial value (depth_coffa 1,
# depth_coffb 0): its gradient is rounding too (measured -6.5e-9 on the H100,
# -3.2e-8 on the CPU: 1.5e-8 of the largest entry), so it is held with the
# key biases
DEPTH_SCALE = "depth_coffa"
# H100 SXM data-sheet peaks (dense): HBM bandwidth, the tensor cores' TF32
# rate (the kernels' matrix products) and the f32 rate outside them
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # the bf16 instances' matrix products
# kernel vs plain version on the card: both sum in f32, in different orders;
# KPConv sums up to K * P * Cin = 307,200 products per output
KPCONV_REL_TOL = 1e-4      # of max |plain output|
ATTENTION_ABS_TOL = 2e-5   # outputs are convex combinations of v ~ N(0, 1)
# the card's full path against the CPU's (plain versions), one pair
CONF_ABS_TOL = 1e-7        # Sinkhorn confidences, valid entries (measured 2.1e-9)
POSE_ABS_TOL = 1e-4        # soft-Procrustes rotation entries / translation (measured 2e-6)
MASK_AGREEMENT = 0.9999    # top-1 union mask: near-ties may flip a few of 495,616 entries
# backbone_forward's confidences come straight from the matcher, not through the
# DDIM loop's last Sinkhorn of a smooth matrix, so the encoder's card-vs-CPU
# difference shows in them: held relative to their largest entry (measured
# 1.2e-5 on the H100; poses and the union mask keep the DDIM phase's limits)
BACKBONE_CONF_REL_TOL = 1e-4
# gradients through each kernel's Function against plain autograd: the backward
# is the same plain recompute, so only the order of its atomic sums differs
GRAD_REL_TOL = 1e-5        # of max |plain gradient| of that input
TRAIN_STEPS = 6            # one warm-up and five timed steps
# one train step, card against CPU (plain versions), one pair. The encoder's
# features differ by ~4e-6 of their scale (the kernels' 3xTF32 sums through 13
# normalised blocks); a difference that size flips a few leaky-ReLU signs,
# max-pool winners and density counts, each of which moves a gradient entry
# discretely. So a gradient tensor's worst entry is held loosely, the median
# over tensors and the whole gradient's relative norm tightly.
LOSS_REL_TOL = 1e-5
GRAD_WORST_TOL = 0.1       # worst tensor: max |card - CPU| / max |CPU gradient| (1.8e-2)
GRAD_MEDIAN_TOL = 5e-3     # median of that over the trained tensors (measured 6.7e-4)
GRAD_GLOBAL_TOL = 1e-2     # ||card - CPU|| / ||CPU|| over all gradients together (1.4e-3)
PARAM_ABS_TOL = 1e-4       # parameters after the SGD step (lr 0.015)
CUT_GAP_MIN = 1e-7         # soft Procrustes' top-k cut must not fall on a near-tie
# the bf16 fast path (compute_dtype bfloat16, precision default): each bf16
# instance against its plain bf16 version, whose roundings it shares; they
# differ where f32 sums in another order land on the other side of a bf16
# rounding, each such flip moving an entry by 2^-8 of itself. KPConv's flips
# are in its inner sums (measured at most 3.3e-4 of max |plain|, the first
# layer); attention's in its bf16 output itself, one ulp of an entry
# (measured 3.7e-3)
KPCONV_BF16_REL_TOL = 2e-3     # of max |plain output|
ATTENTION_BF16_REL_TOL = 1e-2  # of max |plain output|
# pair 0 of the bf16 DDIM, card (kernels) against CPU (plain bf16 versions):
# the confidences relative to their largest (measured 1.0e-3 to 1.1e-3; the
# card's f32 path is 4.2e-3 to 4.3e-3 away, so the limit tells the two paths
# apart), the union mask's agreement (measured 0.99975 and 0.99977: 64 and 58
# of 253,967 entries, near-ties flipped by those differences; the limit
# allows twice the larger count) and no difference outside a near-tie, the
# pose solve on the same confidences (measured 1.3e-6 against POSE_ABS_TOL;
# bf16_pair_check)
CONF_BF16_REL_TOL = 2e-3
MASK_BF16_AGREEMENT = 0.9995
# one bf16 train step of pair 0, card (kernels) against CPU (plain bf16
# versions): the bf16 instances differ from the plain versions where a
# rounding flips (above), and random weights' near-uniform confidences turn
# such differences into others downstream, through 13 normalised blocks and
# the positioning layer's soft-Procrustes pose; the CPU's bf16 step is not
# one number either (its f32 sums, and so its bf16 flips, follow the thread
# count and the host's CPU). tools/spread_port_train_bf16.py on the H100,
# ten draws: card vs CPU loss 1.26e-3 to 1.33e-3, worst tensor 0.38 to 0.66,
# median 7.5e-2 to 7.9e-2, global 0.142 to 0.176 (the CPU at 2 threads
# against 8: 7.3e-4 / 0.56 / 4.9e-2 / 0.153); the card's f32
# step from the same weights and draws is 4.8e-3 to 5.1e-3 / 0.69 to 1.07 /
# 0.187 to 0.211 / 0.37 to 0.47 from its bf16 step. The loss, median and
# global limits lie below every f32 gap and about twice above the spread;
# the worst tensor, whose f32 gap overlaps the spread, is held to its largest
# entry. The SGD update is held by its relative norm.
TRAIN_BF16_LIMITS = {"loss": 4e-3, "worst": 1.0, "median": 0.15, "global": 0.3,
                     "update": 0.3}
# one bf16 train step of 4DMatch pair 0 (704 x 768 tokens, gate 40, its loss
# with the motion term), card against CPU, set as TRAIN_BF16_LIMITS are.
# tools/spread_port_train_bf16.py --4dmatch on the H100, ten draws: card vs CPU
# loss 1.5e-5 to 1.24e-4, worst tensor 0.20 to 0.59, median 2.0e-2 to 2.8e-2,
# global 0.091 to 0.163 (the CPU at 2 threads against 8: 1.7e-5 / 0.31 /
# 1.9e-2 / 0.078); the card's f32 step is 1.0e-4 to 1.9e-4 / 0.31 to 0.50 /
# 3.8e-2 to 5.1e-2 / 0.199 to 0.278 from its bf16 step. The median and global
# limits lie between the two (the SGD update's with the global one); the loss
# and the worst tensor, whose f32 gaps overlap the spread, are held at twice
# the spread's largest and at the tensor's largest entry.
TRAIN_BF16_LIMITS_4D = {"loss": 2.5e-4, "worst": 1.0, "median": 3.5e-2, "global": 0.19,
                        "update": 0.19}
TRAIN_STEPS_4D = 4         # 4DMatch bf16 Trainer: one warm-up and three timed steps
LOSS_4D = {"motion_weight": 0.1, "dataset": "4dmatch"}    # configs/train/4dmatch.yaml
# the synthetic training story (tools/train_synthetic_port.py): its batch, the
# committed weights, and the least held-out success they must reach on the
# card (tests/test_synthetic_training_story.py's threshold)
STORY_BATCH = 8
STORY_PARAMS = os.path.join("snapshot", "train-synthetic-torch", "params.npz")
STORY_SUCCESS_MIN = 0.30
# test pair 0 of the story's DDIM (10 steps, gate 200) on the trained weights,
# at batch 1, card against CPU, in bf16 and in f32; both relative to the
# largest CPU confidence. Measured on an NVIDIA H100 80GB HBM3 at 700 W over
# 13 draws (the 8 pairs of test batch 0 from the eval's start, pair 0 from 5
# other starts): in f32 card vs CPU 1.02e-4 to 1.81e-4, against the bf16
# path's distance from f32 of 2.98e-3 to 2.85e-2 (card) and 3.31e-3 to 2.62e-2
# (CPU); STORY_CONF_F32_REL_TOL lies between, so the f32 check tells the two
# precisions apart. In bf16 the trained model's warps are live at every step
# and soft Procrustes carries a flipped rounding from one step into the next:
# card vs CPU is 1.79e-3 to 2.85e-2 (pair 0 at the eval's start 4.64e-3; over
# its 6 starts at most 5.32e-3), overlapping the gap to f32 for every draw, so
# no bf16 limit tells bf16 from f32. STORY_CONF_BF16_REL_TOL is about twice
# pair 0's largest; the tie-free share and the mask cap do the bf16 checking.
STORY_CONF_BF16_REL_TOL = 1e-2
STORY_CONF_F32_REL_TOL = 1e-3
# the 2D-3D synthetic training story (tools/train_synthetic_2d3d_port.py): its
# batch and committed weights. Its eval on the card must repeat metrics.json's
# RR, IR and FMR of the 16 test pairs to within one pair's worth
# (STORY2D3D_METRIC_TOL): a pair that flips moves each by at most 1/16.
STORY2D3D_BATCH = 4
STORY2D3D_PARAMS = os.path.join("snapshot", "train-synthetic-2d3d-torch", "params.npz")
STORY2D3D_METRIC_TOL = 1.0 / 16
# test pair 0 of its DDIM (10 steps, f32) on the trained weights at batch 1,
# card against CPU, relative to the largest CPU confidence; the start is the
# first CPU-generator seed (of STORY2D3D_START_TRIES) whose top-k cut gaps
# stay at least CUT_GAP_MIN, the PnP draws come from STORY2D3D_PNP_SEED.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W over 11 draws (the 4 pairs of
# test batch 0 from one start, pair 0 from 7 more; tools/
# spread_port_story2d3d_pair0.py): card vs CPU 3.4e-6 to 1.8e-5, the card's
# batch 4 against batch 1 3.7e-6 to 8.5e-6; at twice this limit every real
# node row of those draws is free of a near-tie (with random weights none is)
STORY2D3D_CONF_REL_TOL = 5e-5
STORY2D3D_START_TRIES = 20
STORY2D3D_PNP_SEED = 7
# With random weights the 4DMatch sigmoid confidences sit just above 0.5, so
# the protocol's threshold 0.55 extracts no match; the 4DMatch phase and the
# CLI's on-disk run extract at 0.5 (the mutual-argmax matches), so that IR
# and NFMR do their full work. Phase 20 holds the 4DMatch DDIM at 0.55, on the
# 4D story's trained weights
MATCH_THR_4D = 0.5
# the 4DMatch synthetic training story (tools/train_synthetic_4d_port.py): its
# batch and committed weights. Its eval on the card must repeat metrics.json's
# IR and NFMR of the 32 test pairs within METRIC_4D_ABS_TOL
STORY4D_BATCH = 8
STORY4D_PARAMS = os.path.join("snapshot", "train-synthetic-4d-torch", "params.npz")
# test pair 0 of its stochastic DDIM (10 steps, gate 40) on the trained weights
# at batch 1, card against CPU, in bf16 and in f32 (TF32 off): the sigmoid
# confidences relative to the largest, the pose absolute; the draw is the
# first CPU-generator seed (of STORY4D_DRAW_TRIES) whose step conditions stay
# at least STORY4D_GATE_CLEAR from the gate and whose top-k cut gaps stay at
# least CUT_GAP_MIN on the card. Measured on an NVIDIA H100 80GB HBM3 at 700 W
# over 11 draws (tools/spread_port_story4d_pair0.py: the 8 pairs of test batch
# 0 from the eval's draws, pair 0 from seeds 1-3): in f32 card vs CPU 8.7e-7
# to 1.8e-6 (pose 4.8e-7), against the bf16 path's distance from f32 of 1.8e-3
# to 3.5e-3 (card) and 1.7e-3 to 3.2e-2 (CPU); the f32 limits lie between, so
# the f32 check tells the two precisions apart. In bf16 card vs CPU is 1.8e-3
# to 2.7e-3 on 10 draws and 2.9e-2 on one (pair 6, whose card run at batch 1
# lies as far from its own batch-8 run), pose up to 2.4e-2: it overlaps the
# distance to f32, so no bf16 limit tells bf16 from f32. At the spread's top
# (2.9e-2) only 0.36-0.39 of pair 0's real rows would stay clear of a near-tie
# at twice the limit, so the bf16 confidences are held at about twice pair 0's
# largest reading (2.15e-3 on all four of its draws) and the tie-free share and
# the mask cap do the bf16 checking; the bf16 pose at twice the spread's top
STORY4D_LIMITS = {"bf16": {"conf": 5e-3, "pose": 5e-2}, "f32": {"conf": 1e-5, "pose": 1e-5}}
STORY4D_DRAW_TRIES = 20
STORY4D_GATE_CLEAR = 1.0
# 4DMatch pair 0, card against CPU: sigmoid confidences, valid entries. The
# sigmoid's slope near 0.5 is 1/4 and no Sinkhorn follows it (measured 6.0e-8
# on the H100)
CONF_4D_ABS_TOL = 1e-6
METRIC_4D_ABS_TOL = 1e-2   # IR and NFMR: a flipped match moves IR by 1/n_corr
# the positioning layer's matcher feeds only the detached position code: its
# gradient is exactly zero in the JAX package and None here
NO_GRADIENT = "coarse_transformer.layers.2.0."
# phase 21, data parallel on the card: (a) in a one-process NCCL group the
# data-parallel step must repeat the plain step bit for bit, both under
# deterministic algorithms (index_add_'s atomic adds in the backward otherwise
# change the bits from one run to the next); (b) two processes sharing the
# card over gloo (NCCL takes one process a device), a pair each, against the
# plain step on both pairs, at phase 8's f32 train limits
DP_PAIRS = 2
DP_TIMEOUT_S = 300
# phase 22, the model variants: the KPConv mode instances the variants add (each
# against its plain version at the limits above), and two variants of
# preset_3dmatch at full width. A: the coarsest level's three encoder blocks
# deformable (as KPConv's deformable configurations place them), modulated,
# gaussian influence, the "verticals" dispositions, batch norm off,
# sinusoidal PE, dual-softmax matching; B: constant influence, "closest"
# aggregation, entangled transformers and matchers
VARIANT_MODES = (("constant", "sum"), ("gaussian", "sum"), ("linear", "closest"),
                 ("constant", "closest"), ("gaussian", "closest"))
VARIANTS = {
    "A": {"kpfcn": {"modulated": True, "kp_influence": "gaussian",
                    "fixed_kernel_points": "verticals", "use_batch_norm": False},
          "transformer": {"pe_type": "sinusoidal"}, "matching": {"match_type": "dual_softmax"},
          "modes": ("gaussian", "sum"), "deformable": (8, 9, 10)},
    "B": {"kpfcn": {"kp_influence": "constant", "aggregation_mode": "closest"},
          "transformer": {"entangled": True}, "matching": {"entangled": True},
          "modes": ("constant", "closest"), "deformable": ()},
}
# "closest" keeps each neighbour's nearest kernel point: where the two nearest
# lie within CLOSEST_TIE_REL of each other (squared distances), sums in
# another order may pick the other one. Kernel against plain, a query row
# beyond the limit is excused only where one of its neighbours has such a
# near-tie, at most TIE_EXCUSED_SHARE of the rows; card against CPU, every
# flipped choice must be such a near-tie
CLOSEST_TIE_REL = 1e-5
TIE_EXCUSED_SHARE = 1e-3
# the deformable conv's in-range cut (a neighbour counts when its nearest
# deformed kernel point lies within the extent): card against CPU, a flipped
# neighbour must lie within RANGE_CUT_REL of extent^2 of the cut, at most
# RANGE_FLIP_SHARE of the real neighbours
RANGE_CUT_REL = 1e-4
RANGE_FLIP_SHARE = 1e-3
# pair 0 at gate 40 (the warp inside the DDIM loop on): with random weights
# the gated warps cut soft Procrustes' top-k on near-ties at every start
# (tools/spread_port_variants.py --witness), and where the card keeps its own
# choice the DDIM goes elsewhere (up to 8.6e-2 of the largest confidence).
# So the card keeps the CPU's choices (``topk_choices``), from the first of
# VARIANT_START_TRIES starts whose conditions lie at least VARIANT_GATE_CLEAR
# from the gate on the card, and is held as the DDIM at gate 0 is, with its
# pose at POSE_ABS_TOL
VARIANT_START_TRIES = 20
VARIANT_GATE_CLEAR = 1.0
# pair 0 of the variants, card against CPU. With random weights the DDIM's
# final confidences are near-uniform (every entry about 1/(N+M); variant A's
# after its dual softmax too):
# whole rows tie for the top-1 union mask and soft Procrustes' top-k cut falls
# on exactly equal confidences, so the DDIM (gate 0: the identity warp, no
# pose inside the loop) is held by its confidences relative to the largest
# (VARIANT_CONF_REL_TOL, from tools/spread_port_variants.py) and its mask and
# pose are printed. backbone_forward's confidences come straight from the
# coarse matcher, whose rows have distinct best entries: they are held
# relative to their largest (VARIANT_BACKBONE_REL_TOL, phase 6's limit), the
# mask where no row or column of the CPU confidences has its best two within
# twice that limit (the rest at most 1% + 2 of the mask, with at least
# TIE_FREE_ROWS_MIN of the real rows free of a near-tie), and the pose at
# POSE_ABS_TOL with the same entries kept by soft Procrustes' top-k on both
# devices (variant A's coarse confidences peak at 5e-5, so phase 8's absolute
# CUT_GAP_MIN does not scale to them; the cut's gap is printed); the
# regularizer of pair 0's encode relative. Measured on an NVIDIA H100 80GB HBM3 at 700 W
# (tools/spread_port_variants.py): the DDIM at gate 0 2.0e-6 (A, every start)
# and 1.8e-6 to 2.5e-6 (B, 8 starts) of the largest confidence;
# backbone_forward 2.3e-5 (A) and 7.5e-6 (B), cut gaps 8.8e-9 and 3.5e-7,
# poses 9.7e-7 and 4.9e-6; the regularizer equal
VARIANT_CONF_REL_TOL = {"A": 1e-5, "B": 1e-5}
# one train step of pair 0 at gate 200, card against CPU, at phase 8's limits.
# Variant A's positioning layer (its dual softmax at temperature 0.1 leaves
# the confidences flat, about 1.7e-5 each) cuts soft Procrustes' top-k where
# two CPU entries are exactly equal, whatever the draw (the layer precedes the
# noise): the card keeps another of them, its pose moves (condition 6.971
# against 6.999) and with it the loss (5.5e-5 over 4 draws). Keeping the CPU's
# choice on the card removes that (tools/spread_port_variants.py --witness, on
# an NVIDIA H100 80GB HBM3 at 700 W), so variant A's step runs so (``align_topk``)
VARIANT_ALIGN_TOPK = {"A": True, "B": False}
# the card's own top-k entries that differ from the CPU's must lie within
# TOPK_CUT_REL of the CPU's cut value, at most TOPK_DIFFER_SHARE of the entries
# kept over the calls (measured, the same script: variant A's train step 2 of
# 1533; pair 0 at gate 40, 21 calls of 511, A 424 (0.040), B 28)
TOPK_CUT_REL = 1e-4
TOPK_DIFFER_SHARE = 0.1
VARIANT_BACKBONE_REL_TOL = {"A": 1e-4, "B": 1e-4}
VARIANT_REG_REL_TOL = 1e-5
# phase 23, the shape range: both kernels at shapes their tuned instances do
# not take, each against its plain version at phase 1's limits. KPConv at these
# kernel-point counts (any P but 15 takes an any-P kernel; 16, 17, 32 and 33
# lie on each side of the tensor-core kernel's 16-point chunks), with
# SHAPE_MODE_POINTS also under gaussian/sum and linear/closest; attention at
# these head widths (D not a multiple of 4, or above 136 in f32 and 144 in
# bf16, takes the any-D route; 128 and 136 run in instance 136, 144 in bf16;
# 137, 145 and 257 lie past a padding or slice edge; 1000 passes the
# tensor-core branch's shared memory and takes its CUDA-core branch), at
# SHAPE_ATTENTION (S not a multiple of the 32-key tile, the second pair's last
# 37 keys masked), D = 256 at the 2D-3D image self call, SHAPE_OFFSET_WIDTHS
# on q, k and v offset by one element, and one call whose B * H passes the
# grid's 65,535 rows. Then two configurations of
# configs/test/3dmatch.yaml at full width, written as YAML copies: C (24
# kernel points, 8 heads of 54) and W (2 heads of 216), held card against CPU as
# the variants are (VARIANT_CONF_REL_TOL), and the CLI on C's YAML and on
# configs/test/4dmatch.yaml with one head of 528
SHAPE_POINTS = (1, 7, 16, 17, 24, 32, 33, 64)
# the KPConv kernel behind each route a C entry reports (ops/kpconv.py:ROUTES)
ROUTE_LABELS = {"tuned": "tuned tensor cores", "any_p_tensor_cores": "any-P tensor cores",
                "any_shape_tensor_cores": "any-shape tensor cores"}
# the routes of an encode's 11 layers and of a 2D-3D point-backbone pass's 8
# at 15 kernel points: the first layer (Cin = 1) and the 2D-3D level 0 (K =
# 64) take the any-shape kernel
ENCODE_ROUTES = {"tuned": 10, "any_shape_tensor_cores": 1}
KPCONV_K_TUNED = 40   # the most neighbours the tuned and any-P kernels take
BACKBONE_2D3D_ROUTES = {"tuned": 5, "any_shape_tensor_cores": 3}
SHAPE_MODE_POINTS = (17, 24)
# phase 23's edges of the any-shape KPConv kernel (both dtypes, against the
# plain versions at phase 1's limits): a base layer, 2 pairs of 2,000 points in
# a 0.5 m cube, 1,500 queries near them, K 64 nearest within 0.1 m (the rest
# the sentinel), 32 -> 32, 15 kernel points on a 0.0625 m radius, extent 0.05,
# linear/sum, with one thing changed at a time: Cin on each side of the 8- and
# 32-channel chunks, Cout on each side of the 8- and 64-column tiles, K on
# each side of the tuned kernels' 40 and the 32-neighbour stages, P on each
# side of the 16-point chunks, the other modes, and views offset by one
# element (W's rows then take the kernel's plain loads)
ANY_SHAPE_BASE = {"b": 2, "nq": 1500, "ns": 2000, "k": 64, "cin": 32, "cout": 32, "p": 15,
                  "modes": ("linear", "sum"), "offset": 0}
ANY_SHAPE_EDGES = ([{"cin": c} for c in (1, 3, 16, 31, 32, 33, 48)]
                   + [{"cout": c} for c in (32, 48, 64, 96)]
                   + [{"k": k} for k in (16, 40, 41, 58, 64, 65, 96)]
                   + [{"p": p} for p in (15, 16, 17, 24)]
                   + [{"modes": m, "cin": c} for m in (("gaussian", "sum"), ("linear", "closest"))
                      for c in (1, 32)]
                   + [{"offset": 1, "cin": c, "cout": o} for c, o in ((1, 64), (32, 48), (31, 33))])
# the 4DMatch CLI's on-disk wide layer (K 58, past the tuned kernels' 40), timed
ANY_SHAPE_WIDE = dict(ANY_SHAPE_BASE, b=4, nq=4608, ns=4608, k=58, cin=128, cout=128)
SHAPE_HEAD_WIDTHS = (6, 54, 66, 128, 136, 137, 144, 145, 176, 216, 256, 257, 264, 432, 528,
                     1000)
SHAPE_OFFSET_WIDTHS = (54, 216)
SHAPE_ATTENTION = (4, 2, 705, 709)          # B, H, L, S
SHAPE_IMAGE_SELF = (4, 1, 4602, 4602)
SHAPE_WIDE_BH = (8193, 8, 16, 45)           # B * H = 65,544
SHAPE_GRAD_WIDTHS = (54, 528)
SHAPE_CONFIGS = {"C": {"kpfcn_config": {"num_kernel_points": 24},
                       "coarse_transformer": {"n_head": 8}},
                 "W": {"coarse_transformer": {"n_head": 2}}}
VARIANT_CONF_REL_TOL.update(C=1e-5, W=1e-5)
# Phase 24, the library surface (no CUDA kernel: plain PyTorch on the card,
# each part held against the same function on the CPU on the same inputs and
# draws). Elementwise parts at the CPU tests' limits (tests/test_torch_*_lib.py),
# of the largest entry of the CPU's result: LIB_REL. Where the computation
# itself amplifies f32 rounding (the LRF's x axis, which normalises a sum that
# can nearly cancel; the spatial consistency's a^2 - 2ab + b^2 distances) the
# card must be as near a float64 run as the CPU is, within LIB_F64_FACTOR
# (``held_against_f64``). The PCA normals point by point: each device runs its own 3x3 eigh (cuSOLVER,
# LAPACK), whose eigenvector is right to f32 epsilon over the covariance's
# relative eigengap (lambda_2 - lambda_1) / lambda_3, which the blobby cloud
# takes near 0 at a few points (its least value printed): each point held at
# LIB_NORMAL_GAP_FACTOR times 2^-24 over its gap, plus LIB_REL.
# The k-nearest picks of the features use the matmul-form distance, so a row
# whose picks the two devices' rounding moves (at the cut or in their order)
# must be a near-tie and is left out of the checks (counted). The neighbour searches use the
# exact sum of squares: their indices must be identical, any difference
# explained by a tie or a straddle of the radius within rounding (counted).
# The CPU repeats the first LIB_CPU_ROWS query rows of the 30,000-point
# searches (all of the others).
LIB_REL = 1e-6
LIB_NORMAL_GAP_FACTOR = 8.0
LIB_F64_FACTOR = 4.0
LIB_CPU_ROWS = 4096
LIB_FPS_SAMPLES = 1024
LIB_NORMAL_K = 50
LIB_LRF_K = 32
# 4DMatch source cloud's deformation graph: FPS nodes LIB_NODE_COVERAGE apart
# (176 nodes on phase 9's pair 0), geodesic adjacency within LIB_GRAPH_DISTANCE,
# 8 neighbours a node, 4 anchors a point; LIB_CORR correspondences under the
# GT flow (source point -> source point + flow)
LIB_NODE_COVERAGE = 0.05
LIB_GRAPH_DISTANCE = 0.03
LIB_CORR = 1024
# EPro-PnP: 4,096 correspondences a pair of the 2D-3D phase's clouds and
# cameras, projected under a known pose, LIB_PNP_OUTLIERS of them moved to
# random pixels; 512 samples in 4 AMIS iterations, batch 4, 4 and 6 DoF
LIB_PNP_POINTS = 4096
LIB_PNP_OUTLIERS = 0.1
# the Huber cost's delta, px: each outlier's pull on the pose is bounded by
# delta, so the bias they leave grows with it; the adaptive delta (half the
# 2D points' spread, ~100 px here) leaves the cost quadratic for most
# outliers and the pose far outside PNP_POSE_TOL
LIB_PNP_DELTA = 0.5
# the weights w2d, each axis of each point alike: a softmax over the 4,096
# points times a global scale of 64 (EPro-PnP's networks normalise their
# weights so), which keeps the pose posterior as wide as the proposals can
# hold in f32: at w2d = 1 the pose covariance is ~1e-8, the rotation
# proposal's determinant rounds below 0 and its factorization falls back to
# the default on one device and not the other. The delta applies to weighted
# residuals: scaled alike
LIB_PNP_WEIGHT = 64.0 / LIB_PNP_POINTS
LIB_MC = dict(mc_samples=512, num_iter=4)
LIB_RAYS, LIB_BINS = 4096, 64
# Iterative solvers, card against CPU, of the largest entry (measured on the
# H100 in two runs of this phase, the limits set from them with their reasons):
# Gauss-Newton 6.6e-7 both times: f32 dense solves on Jacobians whose sums each
# device orders its own way; held at 1e-5
LIB_GN_REL = 1e-5
# Adam 2.8e-3 and 4.3e-3: its steps g / sqrt(nu) carry a gradient's rounding
# at full size where the gradient is small, and the card's atomic adds (the
# gathers' backward) change that rounding from run to run; held at 2e-2
LIB_ADAM_REL = 2e-2
# EPro-PnP's pose_opt 2.5e-6 (4 DoF) and 6.5e-6 (6 DoF): the LM's f32 solves;
# held at 1e-4
LIB_MC_POSE_REL = 1e-4
# Its log-weights and the posterior mean they give: card against CPU 1.4e-4
# and 1.1e-6 at 4 DoF, but 1.7e-2 and 5.6e-3 at 6 DoF, whose proposals are
# fitted to an inverse of J^T J that each device rounds its own way and whose
# importance weights rest on a few samples (effective sample size 2-17 of
# 512, costs to ~7e3 in the tails). So both are held against a float64 run on
# the same float32 draws, beside the CPU's own f32 distance from it
# (``held_against_f64``).


# Phase 25, the model zoo: GeoTransformer's forward composed of the zoo's
# pieces at its published 3DMatch width (experiments/geotransformer.3dmatch.
# stage4.gse.k3.max.oacl.stage2.sinkhorn/config.py in the GeoTransformer
# repository): KPConv-FPN 1 -> 64 -> ... -> 1024, output 256 on level 1 (three
# decoder stages), 15 kernel points, voxel 0.025, radius 2.5, sigma 2.0; the
# geometric transformer 1024 -> 256, hidden 256, 4 heads, (self, cross) x 3,
# sigma_d 0.2, sigma_a 15, angle_k 3, max; 256 superpoint correspondences;
# patches of 64 points; 100 Sinkhorn iterations; LGR k 3, mutual, confidence
# 0.05, acceptance radius 0.1, 5 refinement steps. On the 3DMatch phase's 4
# pairs (its pyramid subsampled at 0.03).
ZOO_FPN = dict(input_dim=1, output_dim=256, first_dim=64, kernel_size=15, voxel_size=0.025,
               kpconv_radius=2.5, kpconv_sigma=2.0, encoder_stages=4, decoder_stages=3)
ZOO_BLOCKS = ("self", "cross") * 3
ZOO_GT = dict(input_dim=1024, output_dim=256, hidden_dim=256, num_heads=4, sigma_d=0.2,
              sigma_a=15.0, angle_k=3, angle_reduction="max")
ZOO_CORR = 256
ZOO_PATCH = 64
ZOO_SINKHORN_ITERS = 100
ZOO_DUSTBIN = 1.0
ZOO_POINTS = 4096
ZOO_RENDER_POINTS = 2048
ZOO_PHASE_S = 150
# Pair 0 card against CPU, each card stage on the CPU's inputs of that stage,
# of the largest entry (as first measured on an NVIDIA H100 80GB HBM3, 700 W):
# backbone levels 5.3e-6 (11 KPConvs, GroupNorms); the embedding 4.2e-7 but on
# its self pairs [i, i] 3.3e-4 (a self-pair distance is the square root of each
# device's own rounding of a^2 - 2ab + b^2); the transformer, which mixes those
# entries into every row, 3.8e-5 on the superpoints and 1.4e-6 on the same
# superpoints rounded to a 1/256 grid (exact self-pair distances: the cause
# shown); the lite transformer 1.6e-6 (no whole-degree flip of an angle on
# this data); matching scores 9.0e-7; patch scores 6.1e-14; LGR's pose 3.6e-7
# (absolute). Held at about ten times those.
ZOO_LIMITS = {"backbone_level1": 5e-5, "backbone_level2": 5e-5, "backbone_level3": 5e-5,
              "embedding_pairs": 5e-6, "embedding_self_pairs": 5e-3,
              "transformer": 4e-4, "transformer_grid": 2e-5, "lite": 4e-4, "lite_grid": 2e-5,
              "matching_scores": 1e-5, "patch_points": 0.0, "patch_scores": 1e-6,
              "lgr_rotation": 1e-5, "lgr_translation": 1e-5}
ZOO_CUT_GAP_MIN = 1e-5     # superpoint matching's top-256 cut, relative to the largest score
ZOO_POSE_TOL = 1e-4        # LGR against a known pose (rotation entries, translation)
ZOO_REL = 1e-5             # one module card against CPU, of its largest output
ZOO_DEEP_REL = 1e-4        # deep stacks (ResUNet, VGG, ViT, Predator's GCN)
ZOO_TIE_REL = 1e-6         # a kNN / ball cut within this of the largest squared distance
# the renderer away from its cuts: colours 2.6e-3 and depth 8.5e-5 of the largest
# in one run, 2.4e-7 and 3.0e-7 in another (other draws), before a
# projection at the radius was excused too
ZOO_RENDER_REL = 1e-2
ZOO_RENDER_CUT_PX2 = 0.1   # 4x the a^2 - 2ab + b^2 rounding at pixel coordinates ~640
ZOO_SUBSAMPLE_ABS = 1e-5   # barycentres (metres): the card's atomic sums in f32


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall(fn):
    """(result, seconds) of ``fn`` ending in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(nbytes: float, mma_flops: float, f32_flops: float,
             mma_rate: float = TF32_FLOPS_PER_S):
    """Least time for the work: bytes at the memory rate, matrix-product flops
    at the dense tensor-core rate of their type (TF32 for the f32 kernels,
    whose 3xTF32 spends three tensor-core products per f32 product and so
    reaches at most a third of this bound where the products set it; bf16 for
    the bf16 instances), the other flops at the f32 rate; the units run side
    by side, so the largest of the three."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(mma_flops / mma_rate, f32_flops / F32_FLOPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kpconv_work(q, s, inds, x, w, bf16=False, aggregation_on_tensor_cores=None,
                modes=("linear", "sum")):
    """(bytes, matrix-product flops, other flops) of one KPConv call on these
    inputs; ``bf16``: the bf16 instance's, whose support table (hi, lo,
    features) and weights are bf16, and whose aggregation (influence x
    features, 2 P Cin flops a real neighbour) is a matrix product on the
    tensor cores (``aggregation_on_tensor_cores`` False counts it as other
    flops, the f32 rate, as the first bf16 version's bound did). ``modes``
    (influence, aggregation) set what a neighbour needs: "constant" with "sum"
    reads no distance, "closest" needs every kernel point's distance, their
    argmin and one influence, and weighs on one kernel point (2 Cin flops of
    aggregation a real neighbour)."""
    b, nq, k = inds.shape
    ns, cin = x.shape[1], x.shape[2]
    p, _, cout = w.shape
    influence, closest = modes[0], modes[1] == "closest"
    real = inds < ns                                   # non-sentinel neighbors
    n_nb = int(real.sum())
    n_q = int(real.any(dim=-1).sum())
    nbytes = 4 * (q.numel() + inds.numel() + p * 3 + b * nq * cout)
    if bf16:
        nbytes += 2 * (b * (ns + 1) * (6 + cin) + w.numel())
    else:
        nbytes += 4 * (s.numel() + x.numel() + w.numel())
    # per neighbor: offset and norm (8) and per kernel point a distance (8),
    # where a distance is read; per kernel point whose influence is read, the
    # influence (5); "closest"'s argmin (P); feature-sum test (Cin); influence
    # x features (2 P Cin, or 2 Cin under "closest"); per query: the division,
    # and the [P Cin] x Cout contraction (the product)
    distance = 8 + 8 * p if (influence != "constant" or closest) else 0
    influences = 0 if influence == "constant" else 5 * (1 if closest else p)
    agg_points = 1 if closest else p
    flops = n_nb * (distance + influences + (p if closest else 0) + cin
                    + 2 * agg_points * cin) + n_q * cout
    if aggregation_on_tensor_cores is None:
        aggregation_on_tensor_cores = bf16
    if aggregation_on_tensor_cores:
        aggregation = n_nb * 2 * agg_points * cin
        return nbytes, n_q * 2 * p * cin * cout + aggregation, flops - aggregation
    return nbytes, n_q * 2 * p * cin * cout, flops


def attention_work(q, k, kv_mask):
    b, h, l, d = q.shape
    s = k.shape[2]
    valid_keys = float(kv_mask.sum())                 # summed over the batch
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) + kv_mask.numel()
    # QK^T and PV are the products; exp, sum and scale the rest
    return nbytes, h * l * valid_keys * 4 * d, h * l * valid_keys * 3


def kpconv_layer_calls(model, run, module_type):
    """(q, s, inds, x, kernel_points, weights, extent) of every KPConv call that
    ``run()`` makes through ``module_type`` modules of ``model``: nn/kpfcn.py's
    KPConv (called (q, s, inds, x[, q_mask])) or nn/point_backbone.py's
    KPConvBias (called (q, s, x, inds); its extent is ``sigma``)."""
    import torch

    from diffreg_tpu_torch.nn.kpfcn import KPConv

    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args)))
             for m in model.modules() if isinstance(m, module_type)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    calls = []
    for mod, args in seen:
        if module_type is KPConv:
            q, s, inds, x = args[:4]
            extent = mod.extent
        else:
            q, s, x, inds = args
            extent = mod.sigma
        calls.append((q, s, inds, x.contiguous(), mod.kernel_points, mod.weights.detach(),
                      extent))
    return calls


def closest_near_ties(q, s, inds, kp, bf16=False):
    """Query rows [B, Nq] with a real neighbour whose two nearest kernel points
    lie within CLOSEST_TIE_REL of each other (squared distances computed as
    the plain version computes them; ``bf16``: from the bf16 path's hi + lo
    positions), and the count of such neighbours: where "closest" may pick
    another kernel point under another order of summation."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import _bf16_gather, _gather

    x = torch.zeros(s.shape[0], s.shape[1], 1, device=s.device)
    neighbors, _ = (_bf16_gather if bf16 else _gather)(q, s, inds, x)
    sq_d = (neighbors * neighbors).sum(-1, keepdim=True) + (kp * kp).sum(-1) \
        - 2.0 * torch.einsum("bnkc,pc->bnkp", neighbors, kp)
    two = sq_d.clamp_min(0.0).topk(2, dim=-1, largest=False).values
    tie = ((two[..., 1] - two[..., 0]) <= CLOSEST_TIE_REL * two[..., 1]) & (inds < s.shape[1])
    return tie.any(dim=-1), int(tie.sum())


def held_against_plain(got, ref, allowed, name, aggregation, closest_inputs, flips=None):
    """max |got - ref| (raises above ``allowed``); under "closest" a query row
    beyond it is excused when one of its neighbours has a near-tie between
    two kernel points (``closest_near_ties`` of ``closest_inputs`` (q, s,
    inds, kp, bf16)); with ``flips`` (``bf16_flip_rows``) one whose
    difference is at most one bf16 rounding flip of a term; at most
    TIE_EXCUSED_SHARE of the rows. Returns (max error over the rows held,
    rows excused)."""
    import torch

    diff = (got - ref).abs()
    err = float(diff.max())
    excused = 0
    if (aggregation == "closest" or flips is not None) and err > allowed:
        beyond = (diff > allowed).any(dim=-1)
        explained = torch.zeros_like(beyond)
        if aggregation == "closest":
            explained |= closest_near_ties(*closest_inputs)[0]
        if flips is not None:
            explained |= flips(beyond, diff, allowed)
        excused = int(beyond.sum())
        if bool((beyond & ~explained).any()) or excused > TIE_EXCUSED_SHARE * beyond.numel():
            raise AssertionError(f"{name}: {excused} rows beyond the limit, "
                                 f"{int((beyond & ~explained).sum())} of them without a "
                                 f"near-tie{' or a rounding flip' if flips else ''}")
        err = float(diff[~beyond].max())
    if not math.isfinite(err) or err > allowed:
        raise AssertionError(f"{name}: max abs err {err} (limit {allowed})")
    return err, excused


def bf16_flip_rows(q, s, inds, x, kp, w, extent, modes):
    """For the bf16 path's KPConv on these inputs: a function of (rows beyond
    the limit [B, Nq], |got - ref| [B, Nq, Cout], the limit) giving the rows
    whose every difference lies within the limit plus one bf16 ulp of that
    row's largest single contraction term, max over (p, c) of ulp(A[q, p, c])
    |W[p, c, co]| / count[q], A the rounded influence-weighted sums: what a
    rounding flip of one of them (f32 sums in another order) moves the output
    by. Where P Cin is small (P = 1, Cin = 1: the output is that one term) a
    single flip passes KPCONV_BF16_REL_TOL."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import _bf16_gather, _round_bf16, influence_weights

    def rows(beyond, diff, allowed):
        out = torch.zeros_like(beyond)
        wb = _round_bf16(w).abs().reshape(-1, w.shape[2])                  # [P Cin, Cout]
        for b, n in beyond.nonzero().tolist():
            sel = slice(n, n + 1)
            neighbors, feats = _bf16_gather(q[b:b + 1, sel], s[b:b + 1], inds[b:b + 1, sel],
                                            x[b:b + 1])
            sq_d = ((neighbors * neighbors).sum(-1, keepdim=True) + (kp * kp).sum(-1)
                    - 2.0 * torch.einsum("bnkc,pc->bnkp", neighbors, kp)).clamp_min(0.0)
            infl = _round_bf16(influence_weights(sq_d, extent, *modes))
            a = _round_bf16(torch.einsum("bnkp,bnkc->bnpc", infl, feats)).reshape(-1)
            ulp = torch.where(a != 0, torch.exp2(torch.floor(torch.log2(a.abs())) - 7),
                              torch.zeros_like(a))
            count = max(int((feats.sum(-1) > 0).sum()), 1)
            term = (ulp[:, None] * wb).amax(dim=0) / count                # [Cout]
            out[b, n] = bool((diff[b, n] <= allowed + term).all())
        return out
    return rows


def check_kpconv(calls, n_calls, per, tag="", bf16=False, modes=("linear", "sum"),
                 flip_excuse=False):
    """Kernel vs plain KPConv at every distinct layer of ``calls`` (the inputs
    the backbone really feeds each layer); ``bf16``: the bf16 instance against
    the plain bf16 version; ``modes``: (influence, aggregation), each pair an
    instance of the kernel; ``flip_excuse`` (bf16): a row beyond the limit is
    excused where one bf16 rounding flip of a term explains it
    (``bf16_flip_rows``). Returns the kernel's JSON entry and the distinct
    layers {(nq, ns, k, cin, cout): (inputs, calls)}."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)

    if bf16:
        # the kernel's own inputs (the bf16 table and weights), built once a shape
        def kernel(q, s, inds, x, kp, w, extent, *m):
            return kpconv_cuda_bf16(q, tables[id(x)], inds, kp, weights[id(w)], extent, *m)
        counted, plain, limit = kpconv_cuda_bf16, kpconv_bf16_plain, KPCONV_BF16_REL_TOL
        tables = {id(a[3]): kpconv_bf16_table_aligned(a[1], a[3]) for a in calls}
        weights = {id(a[5]): a[5].to(torch.bfloat16).contiguous() for a in calls}
    else:
        kernel, counted, plain, limit = kpconv_cuda, kpconv_cuda, kpconv, KPCONV_REL_TOL

    if len(calls) != n_calls:
        raise AssertionError(f"expected {n_calls} KPConv calls per encode, saw {len(calls)}")
    shapes = {}
    for args in calls:
        q, s, inds, x, _, w, _ = args
        key = (q.shape[1], s.shape[1], inds.shape[2], x.shape[2], w.shape[2])
        shapes.setdefault(key, [args, 0])[1] += 1
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "mma_flops": 0.0, "flops": 0.0}
    first_bound = {"bytes": 0.0, "mma_flops": 0.0, "flops": 0.0}  # bf16: aggregation at the f32 rate
    worst, per_shape, excused_rows = 0.0, [], 0
    with torch.inference_mode():
        for (nq, ns, k, cin, cout), (args, count) in shapes.items():
            q, s, inds, x, kpts, w, _ = args
            before, routes = counted.launches, dict(counted.route_launches)
            got = kernel(*args, *modes)
            ref = plain(*args, *modes)
            torch.cuda.synchronize()
            assert counted.launches == before + 1
            route = [r for r, n in counted.route_launches.items() if n != routes.get(r, 0)][0]
            scale = float(ref.abs().max())
            allowed = limit * (scale if bf16 else max(scale, 1.0))
            flips = bf16_flip_rows(*args, modes) if bf16 and flip_excuse else None
            err, excused = held_against_plain(got, ref, allowed,
                                              f"kpconv{tag} {nq}/{ns}/{k}/{cin}->{cout}",
                                              modes[1], (q, s, inds, kpts, bf16), flips)
            worst = max(worst, err)
            excused_rows += excused
            ms = time_cuda(lambda: kernel(*args, *modes), 20)
            plain_ms = time_cuda(lambda: plain(*args, *modes), 3, warmup=1)
            work = kpconv_work(q, s, inds, x, w, bf16, modes=modes)
            bms, by = bound_ms(*work, BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
            path = ROUTE_LABELS[route]
            per_shape.append({"nq": nq, "ns": ns, "k": k, "cin": cin, "cout": cout,
                              "calls": count, "route": route, "path": path, "ms": ms,
                              "plain_ms": plain_ms,
                              "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                              "max_abs_plain": scale, "excused_rows": excused})
            log(f"kpconv{tag} {nq}/{ns}/K{k}/{cin}->{cout} x{count} ({path}): err {err:.3e} "
                f"= {err / max(scale, 1e-30):.3e} of max |plain| (limit {allowed:.3e}"
                f"{f'; {excused} rows excused' if excused else ''}) kernel "
                f"{ms:.4f} ms plain "
                f"{plain_ms:.4f} ms bound {bms:.4f} ms ({by})")
            totals["ms"] += count * ms
            totals["plain_ms"] += count * plain_ms
            for key, val in zip(("bytes", "mma_flops", "flops"), work):
                totals[key] += count * val
            if bf16:
                old = kpconv_work(q, s, inds, x, w, True, aggregation_on_tensor_cores=False,
                                  modes=modes)
                per_shape[-1]["bound_ms_aggregation_f32"] = bound_ms(*old, BF16_FLOPS_PER_S)[0]
                for key, val in zip(("bytes", "mma_flops", "flops"), old):
                    first_bound[key] += count * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"],
                       BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
    name = "kpconv_bf16" if bf16 else "kpconv"
    if modes != ("linear", "sum"):
        name += "_" + "_".join(modes)
    entry = {"name": name, "route": "cuda",
             "source": f"diffreg_tpu_torch/csrc/{'kpconv_bf16' if bf16 else 'kpconv'}.cu",
             "replaces": "diffreg_tpu/ops/pallas/kpconv_kernel.py:38",
             "launches": None, "max_abs_err": worst, "ms": totals["ms"],
             "plain_ms": totals["plain_ms"], "bound_ms": bms, "bound_by": by,
             "library_ms": None, "per": per, "shapes": per_shape,
             "excused_rows": excused_rows}
    if bf16:
        entry["bound_ms_aggregation_f32"], _ = bound_ms(
            first_bound["bytes"], first_bound["mma_flops"], first_bound["flops"], BF16_FLOPS_PER_S)
        log(f"kpconv{tag}: bound {bms:.4f} ms ({by}; aggregation as bf16 matrix flops), "
            f"{entry['bound_ms_aggregation_f32']:.4f} ms with it at the f32 rate")
    return entry, shapes


def any_shape_entries(kernels, launches):
    """The any-shape KPConv kernels' JSON entries (f32, bf16): launches on the
    main paths (phase 4's and the 2D-3D testers' runs; phase 8b's bf16 DDIM),
    times and bounds summed over the layers that took them at the timed
    unit (f32: the 2D-3D point backbone's level-0 trio, phase 12; bf16: the
    first layer of the bf16 encode, phase 8b), the largest error over every
    layer checked in phases 3-12 that took them, and phase 23f's edges."""
    edges = next(e for e in kernels if e["name"] == "kpconv_any_p").pop("any_shape_edges")
    entries = []
    for bf16 in (False, True):
        src = kernels[2] if bf16 else kernels[0]
        rows = [dict(r, at=key) for key in ("shapes", "shapes_4dmatch", "shapes_2d3d")
                for r in src.get(key, []) if r["route"] == "any_shape_tensor_cores"]
        timed = [r for r in rows if r["at"] == ("shapes" if bf16 else "shapes_2d3d")]
        name = "kpconv_bf16_any_shape" if bf16 else "kpconv_any_shape"
        entries.append({
            "name": name, "route": "cuda",
            "source": f"diffreg_tpu_torch/csrc/{'kpconv_bf16' if bf16 else 'kpconv'}.cu",
            "shared_steps": "diffreg_tpu_torch/csrc/kpconv_common.cuh",
            "replaces": "diffreg_tpu/ops/pallas/kpconv_kernel.py:38",
            "launches": launches[name],
            "launches_phase23": launches[f"{'kpconv_bf16' if bf16 else 'kpconv'}"
                                         "_any_shape_tensor_cores"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] * r["calls"] for r in timed) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": max(timed, key=lambda r: r["bound_ms"])["bound_by"], "library_ms": None,
            "per": ("the first layer of a bf16 3DMatch encode (1 -> 128, K 32)" if bf16 else
                    "the 2D-3D point backbone's level 0 (1 -> 64, 32 -> 32 and the strided "
                    "32 -> 32, K 64)"),
            "shapes": rows, "edges": edges["bf16" if bf16 else "f32"]})
    return entries


def attention_calls(n_src, n_tgt, layer_types):
    """Attention launches of one pass of a transformer with these layer types
    (nn/transformer.py): a self layer is one [2B] call when both sides have as
    many tokens and one call per side when not; a cross layer is two calls."""
    per_self = 1 if n_src == n_tgt else 2
    return sum(per_self if lt == "self" else 2 if lt == "cross" else 0 for lt in layer_types)


def attention_cases(batch, cfg):
    """The denoiser's attention calls in one DDIM step, as (name, query
    length, key mask, calls): the self layers as one [2B] call, or one per
    side when the sides' token counts differ; then both cross directions."""
    import torch

    src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
    s, t = src_mask.shape[1], tgt_mask.shape[1]
    n_self = cfg.denoising_layer_types.count("self")
    n_cross = cfg.denoising_layer_types.count("cross")
    if s == t:
        cases = [("self", s, torch.cat([src_mask, tgt_mask]), n_self)]
    else:
        cases = [("self_src", s, src_mask, n_self), ("self_tgt", t, tgt_mask, n_self)]
    return cases + [("cross", s, tgt_mask, n_cross), ("cross_back", t, src_mask, n_cross)]


def check_attention(batch, cfg, gen, tag="", bf16=False):
    """Kernel vs plain attention at the denoiser's shapes (``attention_cases``)
    with the batch's key masks; times scaled_dot_product_attention (in the
    same dtype) as the yardstick. ``bf16``: the bf16 instance on bf16 q, k, v
    against the plain bf16 version, the error relative to the largest plain
    entry. Returns the kernel's JSON entry (totals per DDIM step of ``cfg``)."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.ops.attention import (masked_attention_bf16_plain,
                                                 masked_attention_cuda,
                                                 masked_attention_cuda_bf16,
                                                 masked_attention_plain)

    if bf16:
        kernel, plain, dtype = masked_attention_cuda_bf16, masked_attention_bf16_plain, \
            torch.bfloat16
    else:
        kernel, plain, dtype = masked_attention_cuda, masked_attention_plain, torch.float32

    h = cfg.coarse_transformer.n_head
    d = cfg.coarse_transformer.feature_dim // h
    scale = d ** -0.5
    cases = attention_cases(batch, cfg)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "mma_flops": 0.0,
              "flops": 0.0}
    worst, per_shape = 0.0, []
    with torch.inference_mode():
        for name, length, kv_mask, calls in cases:
            bb, keys = kv_mask.shape
            q = torch.randn(bb, h, length, d, generator=gen).to("cuda", dtype)
            k, v = (torch.randn(bb, h, keys, d, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            kv_mask = kv_mask.contiguous()
            before = kernel.launches
            got = kernel(q, k, v, kv_mask, scale)
            ref = plain(q, k, v, kv_mask, scale)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1 and got.dtype == dtype
            err = float((got.float() - ref.float()).abs().max())
            limit = ATTENTION_BF16_REL_TOL * float(ref.float().abs().max()) if bf16 \
                else ATTENTION_ABS_TOL
            if not math.isfinite(err) or err > limit:
                raise AssertionError(f"attention {name}{tag}: max abs err {err} (limit {limit})")
            worst = max(worst, err)
            lib_mask = kv_mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=scale)
            lib_err = float((lib.float() - ref.float()).abs().max())
            ms = time_cuda(lambda: kernel(q, k, v, kv_mask, scale), 20)
            plain_ms = time_cuda(lambda: plain(q, k, v, kv_mask, scale), 10)
            lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=scale), 20)
            nbytes, mma_flops, flops = attention_work(q, k, kv_mask)
            rate = BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S
            bms, by = bound_ms(nbytes, mma_flops, flops, rate)
            per_shape.append({"case": name + tag, "b": bb, "h": h, "l": length, "s": keys, "d": d,
                              "calls": calls, "ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                              "max_abs_err": err, "library_max_abs_err": lib_err})
            log(f"attention{' bf16' if bf16 else ''} {name}{tag} [{bb},{h},{length}x{keys},{d}] "
                f"x{calls}: err {err:.3e} = {err / float(ref.float().abs().max()):.3e} of max "
                f"|plain| (limit {limit:.1e}) kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms (err {lib_err:.3e}) "
                f"bound {bms:.4f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bytes", nbytes), ("mma_flops", mma_flops), ("flops", flops)):
                totals[key] += calls * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"],
                       BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
    return {"name": "masked_attention_bf16" if bf16 else "masked_attention", "route": "cuda",
            "source": "diffreg_tpu_torch/csrc/attention.cu",
            "replaces": "diffreg_tpu/ops/pallas/attention_kernel.py:24",
            "launches": None, "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": totals["library_ms"],
            "per": f"one DDIM step ({sum(c[3] for c in cases)} calls)", "shapes": per_shape}


def grad_case(name, function, inputs, wanted, plain, gen, calls, counter):
    """Gradients of a fixed random projection of ``function``'s output (the
    kernel's autograd Function) against the same through ``plain``, for the
    inputs at positions ``wanted``; one launch per forward. Returns
    (worst relative error, backward ms per call)."""
    import torch

    def leaves():
        return [t.detach().clone().requires_grad_(i in wanted) for i, t in enumerate(inputs)]
    args = leaves()
    before = counter.launches
    out = function(*args)
    assert counter.launches == before + 1, f"{name}: {counter.launches - before} launches"
    if out.grad_fn is None:
        raise AssertionError(f"{name}: the kernel's output has no grad_fn")
    proj = torch.randn(out.shape, generator=gen).to(out.device, out.dtype)
    got = torch.autograd.grad(out, [args[i] for i in wanted], proj, retain_graph=True)
    assert counter.launches == before + 1, f"{name}: the backward launched the kernel"
    ref_args = leaves()
    ref = torch.autograd.grad(plain(*ref_args), [ref_args[i] for i in wanted], proj)
    torch.cuda.synchronize()
    worst = 0.0
    for g, r in zip(got, ref):
        err = float((g.float() - r.float()).abs().max()) / max(float(r.float().abs().max()), 1e-30)
        if not math.isfinite(err) or err > GRAD_REL_TOL:
            raise AssertionError(f"{name}: gradient differs from plain autograd by {err} "
                                 "of its largest entry")
        worst = max(worst, err)
    ms = time_cuda(lambda: torch.autograd.grad(out, [args[i] for i in wanted], proj,
                                               retain_graph=True), 5, warmup=1)
    log(f"grad {name} x{calls}: dinputs rel err {worst:.3e} (limit {GRAD_REL_TOL:.0e}), "
        f"backward {ms:.4f} ms")
    return worst, ms


def check_gradients(kernels, kp_shapes, batch, cfg, gen):
    """Phase 3b: each kernel's autograd Function at the main path's shapes."""
    worst, total = kpconv_gradients(kp_shapes, gen)
    kernels[0].update({"backward_ms": total, "backward_route": "plain recompute",
                       "backward_max_rel_err": worst})
    worst, total = attention_gradients(batch, cfg, gen)
    kernels[1].update({"backward_ms": total, "backward_route": "plain recompute",
                       "backward_max_rel_err": worst})


def kpconv_gradients(kp_shapes, gen, bf16=False, modes=("linear", "sum")):
    """KPConvFunction (``bf16``: KPConvBF16Function) against plain autograd at
    each distinct layer, for the features and the weights, in ``modes``;
    returns (worst relative error, backward ms of all the layers' calls)."""
    from diffreg_tpu_torch.ops.kpconv import (KPConvBF16Function, KPConvFunction, kpconv,
                                              kpconv_bf16_plain, kpconv_cuda, kpconv_cuda_bf16)

    function, plain, counter = ((KPConvBF16Function, kpconv_bf16_plain, kpconv_cuda_bf16)
                                if bf16 else (KPConvFunction, kpconv, kpconv_cuda))
    worst, total = 0.0, 0.0
    for (nq, ns, k, cin, cout), ((*inputs, ext), calls) in kp_shapes.items():
        err, ms = grad_case(
            f"kpconv{' bf16' if bf16 else ''} {'/'.join(modes)} {nq}/{ns}/K{k}/{cin}->{cout}",
            lambda *a: function.apply(*a, ext, *modes), tuple(inputs), (3, 5),
            lambda *a: plain(*a, ext, *modes), gen, calls, counter)
        worst, total = max(worst, err), total + calls * ms
    return worst, total


def attention_gradients(batch, cfg, gen, bf16=False):
    """MaskedAttentionFunction (``bf16``: MaskedAttentionBF16Function on bf16
    q, k, v) against plain autograd at the denoiser's shapes of ``cfg``;
    returns (worst relative error, backward ms per DDIM step)."""
    import torch

    from diffreg_tpu_torch.ops.attention import (MaskedAttentionBF16Function,
                                                 MaskedAttentionFunction,
                                                 masked_attention_bf16_plain,
                                                 masked_attention_cuda,
                                                 masked_attention_cuda_bf16,
                                                 masked_attention_plain)

    function, plain, counter, dtype = (
        (MaskedAttentionBF16Function, masked_attention_bf16_plain, masked_attention_cuda_bf16,
         torch.bfloat16) if bf16 else
        (MaskedAttentionFunction, masked_attention_plain, masked_attention_cuda, torch.float32))
    h = cfg.coarse_transformer.n_head
    d = cfg.coarse_transformer.feature_dim // h
    scale = d ** -0.5
    worst, total = 0.0, 0.0
    for name, length, kv_mask, calls in attention_cases(batch, cfg):
        bb, keys = kv_mask.shape
        qkv = [torch.randn(bb, h, n, d, generator=gen).to("cuda", dtype)
               for n in (length, keys, keys)]
        err, ms = grad_case(
            f"attention{' bf16' if bf16 else ''} {name} [{bb},{h},{length}x{keys},{d}]",
            lambda *a: function.apply(*a, scale), (*qkv, kv_mask.contiguous()),
            (0, 1, 2), lambda *a: plain(*a, scale), gen, calls, counter)
        worst, total = max(worst, err), total + calls * ms
    return worst, total


def check_outputs(out, tag):
    import torch

    for key in ("conf_matrix_pred", "rotation_pred", "translation_pred", "ransac_rotation",
                "ransac_translation"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{tag}: {key} is not finite")
    for key in ("rotation_pred", "ransac_rotation"):
        r = out[key].double()
        eye = torch.eye(3, dtype=r.dtype, device=r.device)
        orth = float((r @ r.transpose(1, 2) - eye).abs().max())
        det = torch.linalg.det(r)
        if orth > 1e-4 or float((det - 1).abs().max()) > 1e-4:
            raise AssertionError(f"{tag}: {key} not a rotation (orth {orth}, det {det.tolist()})")


def check_ransac(src, rot, trn, u, gen):
    import torch

    from diffreg_tpu_torch.eval.ransac import ransac_pose

    src = src.cpu()[None]
    tgt = src @ rot.T + trn.T
    # outliers: moved 0.3 to 0.8 m off their true position, so none is an inlier
    outliers = torch.rand(src.shape[1], generator=gen) < 0.4
    away = torch.randn(int(outliers.sum()), 3, generator=gen)
    away = away / away.norm(dim=1, keepdim=True) * (0.3 + 0.5 * torch.rand(len(away), 1,
                                                                               generator=gen))
    tgt[0, outliers] += away
    valid = torch.ones(src.shape[:2], dtype=torch.bool)
    poses = {"card": ransac_pose(u.cuda(), src.cuda(), tgt.cuda(), valid.cuda()),
             "CPU": ransac_pose(u, src, tgt, valid)}
    for name, res in poses.items():
        err = max(float((res.rotation[0].cpu() - rot).abs().max()),
                  float((res.translation[0].cpu() - trn).abs().max()))
        log(f"RANSAC on the {name}: {int(res.inlier_count[0])} inliers of {src.shape[1]} "
            f"({int((~outliers).sum())} true), pose error {err:.3e}")
        if not err <= POSE_ABS_TOL:
            raise AssertionError(f"RANSAC on the {name} missed the ground-truth pose by {err}")


def compare_pair(got, ref, valid, tag, conf_tol=CONF_ABS_TOL):
    """Pair 0 of the card's output against the CPU's: confidences within
    ``conf_tol``, the DDIM phase's limits on poses and the union mask."""
    conf_err = float((got["conf_matrix_pred"][:1].cpu() - ref["conf_matrix_pred"]).abs()[valid].max())
    rot_err = float((got["rotation_pred"][:1].cpu() - ref["rotation_pred"]).abs().max())
    trn_err = float((got["translation_pred"][:1].cpu() - ref["translation_pred"]).abs().max())
    mask_agree = float((got["corr_mask"][:1].cpu() == ref["corr_mask"])[valid].float().mean())
    log(f"card vs CPU {tag}: conf {conf_err:.3e} (limit {conf_tol:.3e}), corr_mask agreement "
        f"{mask_agree:.6f}, rotation {rot_err:.3e}, translation {trn_err:.3e}")
    if not conf_err <= conf_tol:
        raise AssertionError(f"{tag}: conf differs from the CPU run by {conf_err}")
    if not mask_agree >= MASK_AGREEMENT:
        raise AssertionError(f"{tag}: corr_mask agrees on {mask_agree} of entries")
    if not max(rot_err, trn_err) <= POSE_ABS_TOL:
        raise AssertionError(f"{tag}: pose differs from the CPU run by {max(rot_err, trn_err)}")


def run_backbone(model, batch, cpu_model, one, launches):
    """Phase 6: ``backbone_forward`` on the card, timed, and pair 0 on the CPU."""
    import torch

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    with torch.no_grad():
        model.backbone_forward(batch)                          # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            out, seconds = wall(lambda: model.backbone_forward(batch))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 11 or n_at != 6:
                raise AssertionError(f"backbone_forward: {n_kp} KPConv launches (want 11), "
                                     f"{n_at} attention launches (want 6)")
            launches["kpconv"] += n_kp
            launches["masked_attention"] += n_at
            times.append(seconds)
        seconds = sorted(times)[TIMED_RUNS // 2]
        for key in ("conf_matrix_pred", "rotation_pred", "translation_pred"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"backbone_forward: {key} is not finite")
        log(f"backbone_forward gate 0: {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = {BATCH_PAIRS / seconds:.3f} pairs/s; "
            f"launches kpconv {n_kp} attention {n_at}")
        t0 = time.perf_counter()
        ref = cpu_model.backbone_forward(one)
        cpu_s = time.perf_counter() - t0
        feats, ref_feats = model.encode(batch)[0][:1].cpu(), cpu_model.encode(one)[0]
    rows = one.src_mask
    feat_err = float((feats - ref_feats)[rows].abs().max()) / float(ref_feats[rows].abs().max())
    log(f"encode card vs CPU, pair 0: source features differ by {feat_err:.3e} of their "
        "largest entry")
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    top = float(ref["conf_matrix_pred"][valid].max())
    compare_pair(out, ref, valid, f"backbone_forward (CPU {cpu_s:.1f} s, "
                 f"max confidence {top:.4f})", BACKBONE_CONF_REL_TOL * top)


def trained_grads_finite(model, grads, tag):
    """Every trained parameter but the positioning matcher has a finite gradient
    (and but a dual-softmax model's denoising dustbin score, which only the
    detached warp and the DDIM's last projection read)."""
    import torch

    skip = (NO_GRADIENT,)
    matching = getattr(model.cfg, "coarse_matching", None)
    if matching is not None and matching.match_type != "sinkhorn":
        skip += ("denoising_coarse_matching.bin_score",)
    missing = [n for (n, _), g in zip(model.named_trained_parameters(), grads)
               if not n.startswith(skip) and (g is None or not bool(torch.isfinite(g).all()))]
    if missing:
        raise AssertionError(f"{tag}: no finite gradient for {missing}")
    nonzero = sum(int(g is not None and bool((g != 0).any())) for g in grads)
    log(f"{tag}: {len(grads)} trained parameters, {nonzero} with a nonzero gradient, "
        f"all finite but the positioning matcher's")


def run_training(cfg_train, batch, launches, bf16=False, loss_cfg=None, tag="3DMatch",
                 steps=TRAIN_STEPS, attention_key=None):
    """Phase 7 (and 8c in bf16): the Trainer for one epoch of ``steps`` steps
    at full width, then resume. Each step launches 11 KPConv and the
    transformers' attention calls through the kernels of its dtype (bf16: the
    bf16 instances and no f32 kernel), counted into ``launches``."""
    import tempfile

    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
    from diffreg_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16
    from diffreg_tpu_torch.utils.logging import Timers

    loss_cfg = loss_cfg or LossConfig()
    optim = OptimConfig(steps_per_epoch=steps)            # the reference SGD, ExpLR per epoch
    step = make_train_step(loss_cfg)
    counted = (kpconv_cuda_bf16, masked_attention_cuda_bf16) if bf16 else \
        (kpconv_cuda, masked_attention_cuda)
    others = (kpconv_cuda, masked_attention_cuda) if bf16 else ()
    keys = ("kpconv_bf16" if bf16 else "kpconv",
            attention_key or ("masked_attention_bf16" if bf16 else "masked_attention"))
    want_at = attention_calls(batch.src_mask.shape[1], batch.tgt_mask.shape[1],
                              tuple(cfg_train.coarse_transformer.layer_types)
                              + tuple(cfg_train.denoising_layer_types))
    rows = []

    def counted_step(state, b, inputs, timers=None):
        phases = Timers()
        for fn in counted + others:
            fn.launches = 0
        state, info = step(state, b, inputs, phases)
        n_kp, n_at = (fn.launches for fn in counted)
        n_other = sum(fn.launches for fn in others)
        loss = float(info["loss"])
        if n_kp != 11 or n_at != want_at or n_other:
            raise AssertionError(f"train step {tag}: {n_kp} KPConv launches (want 11), {n_at} "
                                 f"attention launches (want {want_at}), {n_other} launches of "
                                 "the other dtype's kernels (want 0)")
        if not math.isfinite(loss) or not bool(info["grads_finite"]):
            raise AssertionError(f"train step {tag}: loss {loss}, grads finite "
                                 f"{bool(info['grads_finite'])}")
        launches[keys[0]] += n_kp
        launches[keys[1]] += n_at
        rows.append({"loss": loss, "grad_norm": float(info["grad_norm"]), **phases.summary()})
        return state, info

    model = DiffusionMatchingModel(cfg_train, device="cuda", seed=0)
    state = create_train_state(model, optim)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(counted_step, state, lambda epoch: ((batch, None) for _ in range(steps)),
                          TrainerConfig(max_epoch=1, log_every=steps, save_dir=tmp), seed=0)
        t0 = time.perf_counter()
        state = trainer.train()
        epoch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        fresh = create_train_state(DiffusionMatchingModel(cfg_train, device="cuda", seed=1),
                                   optim)
        resumed = Trainer(step, fresh, lambda epoch: iter(()),
                          TrainerConfig(max_epoch=1, save_dir=tmp), seed=0)
        resumed.resume()
    same = all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                 resumed.state.model.parameters()))
    if not (same and resumed.start_epoch == 1 and resumed.state.step == steps
            and resumed.state.optimizer.count == steps):
        raise AssertionError(f"resume {tag}: params equal {same}, epoch {resumed.start_epoch}, "
                             f"step {resumed.state.step}, updates {resumed.state.optimizer.count}")
    if bf16 and not all(t.dtype == torch.float32 for t in (
            *state.optimizer.params, *state.optimizer.buffers["momentum"].values())):
        raise AssertionError(f"train {tag}: a parameter or momentum buffer is not float32")
    timed = rows[1:]
    med = lambda key: sorted(r[key] for r in timed)[len(timed) // 2]
    step_s = med("forward") + med("backward") + med("optimizer")
    gate = cfg_train.procrustes.max_condition_num
    log(f"train {tag}{' bf16' if bf16 else ''} (gate {gate:g}, {BATCH_PAIRS} pairs, SGD lr "
        f"{optim.lr}): {steps} steps in {epoch_s:.3f} s (epoch with checkpoint); per timed "
        f"step median forward {med('forward'):.4f} s, backward {med('backward'):.4f} s, "
        f"optimizer {med('optimizer'):.4f} s = {step_s:.4f} s: {1 / step_s:.3f} steps/s, "
        f"{BATCH_PAIRS / step_s:.3f} pairs/s; peak memory {peak:.2f} GiB; launches a step "
        f"kpconv 11 attention {want_at}{', f32 0' if bf16 else ''}; resume ok")
    log(f"train {tag} losses " + ", ".join(f"{r['loss']:.5f}" for r in rows) + "; grad norms "
        + ", ".join(f"{r['grad_norm']:.4f}" for r in rows))
    log(f"train {tag} step seconds (forward, backward, optimizer) " + "; ".join(
        f"{r['forward']:.4f} {r['backward']:.4f} {r['optimizer']:.4f}" for r in rows))

    inputs = model.draw_train_inputs(batch, trainer.generator)
    out = model.train_forward(batch, **inputs)
    params = [p for _, p in model.named_trained_parameters()]
    grads = torch.autograd.grad(diffreg_loss(out, batch, loss_cfg)[0], params,
                                allow_unused=True)
    trained_grads_finite(model, grads, f"train {tag} backward ({BATCH_PAIRS} pairs)")
    return {"steps_per_s": 1 / step_s, "pairs_per_s": BATCH_PAIRS / step_s,
            "forward_s": med("forward"), "backward_s": med("backward"),
            "optimizer_s": med("optimizer"), "peak_gib": peak, "epoch_s": epoch_s,
            "launches_per_step": {"kpconv": 11, "masked_attention": want_at},
            "losses": [r["loss"] for r in rows]}


def noisy_warp_cut_gap(model, batch, inputs):
    """Cut gap of soft Procrustes' top-k in the gated warp of the noisy GT
    matrix (``train_forward``'s noising of either variant)."""
    import torch

    from diffreg_tpu_torch.diffusion.schedule import q_sample, signed_fractional_noise
    from diffreg_tpu_torch.models.diffusion_matching import masked_min

    with torch.no_grad():
        if model.cfg.variant == "4dmatch":
            x = torch.sigmoid(q_sample(model.schedule, batch.matrix_gt(), inputs["t"],
                                       inputs["g"]))
        else:
            x = q_sample(model.schedule, batch.matrix_gt(), inputs["t"],
                         signed_fractional_noise(inputs["g"]))
            x = torch.nan_to_num(x, nan=0.0)
            x = x - masked_min(x, batch.src_mask, batch.tgt_mask)
        conf = model.denoising_coarse_matching.sinkhorn(x, batch.src_mask, batch.tgt_mask)
        return cut_gap(conf, batch.src_mask, batch.tgt_mask)


def cut_gap(conf, src_mask, tgt_mask):
    """Smallest gap, over the pairs, at soft Procrustes' top-k cut; infinite
    where the confidences at the cut are 0 (a dual softmax's underflowed
    entries), which weigh nothing whichever are kept."""
    gaps = []
    for i in range(conf.shape[0]):
        top = conf[i].detach().flatten().sort(descending=True).values
        cut = int(max(src_mask[i].sum(), tgt_mask[i].sum()))
        gaps.append(float(top[cut - 1] - top[cut]) if float(top[cut - 1]) > 0 else math.inf)
    return min(gaps)


def step_gaps(a, b, names):
    """How far train step ``a`` lies from ``b`` (dicts of the loss and the
    gradients in ``names`` order, and where they hold them the parameters
    before and after the SGD step): the loss's relative difference; per
    gradient tensor max |a - b| / max |b|, sorted worst first; the median of
    those; the whole gradient's relative norm; the parameters' largest
    difference and the SGD update's relative norm."""
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    errs, diff_sq, ref_sq = [], 0.0, 0.0
    for n, g_a, g_b in zip(names, a["grads"], b["grads"]):
        if (g_a is None) != (g_b is None):
            raise AssertionError(f"train step: gradient of {n} is None on one side only")
        if g_b is not None:
            diff = (g_a - g_b).double()
            errs.append((float(diff.abs().max()) / max(float(g_b.abs().max()), 1e-30), n))
            diff_sq += float((diff * diff).sum())
            ref_sq += float((g_b.double() ** 2).sum())
    errs.sort(reverse=True)
    gap = {"loss": loss_err, "errs": errs, "worst": errs[0][0],
           "median": errs[len(errs) // 2][0], "global": math.sqrt(diff_sq / ref_sq)}
    if "params" in a:
        moved = lambda r: [p - q for p, q in zip(r["params"], r["before"])]  # noqa: E731
        update_sq = sum(float(((u - v).double() ** 2).sum())
                        for u, v in zip(moved(a), moved(b)))
        update_ref = sum(float((v.double() ** 2).sum()) for v in moved(b))
        gap.update(params=max(float((p - q).abs().max())
                              for p, q in zip(a["params"], b["params"])),
                   update=math.sqrt(update_sq / update_ref))
    return gap


def train_step_card_vs_cpu(cfg_train, one, limits=None, f32_cfg=None, tag="", loss_cfg=None,
                           first_seed=0, align_topk=False):
    """Phase 8 (and 8c in bf16, 8d for 4DMatch, 22 for the variants): one
    train step of one pair on the card and on the CPU from the same weights
    and draws (the first draw from ``first_seed`` on whose noisy-matrix warp
    cuts its top-k in a wide gap), held to
    ``limits`` (loss, worst, median, global, and params or update; default
    the f32 ones), with ``loss_cfg`` (default the 3DMatch loss). ``f32_cfg``:
    the card's f32 step from the same weights and draws too, whose gap to the
    card's step is printed beside the limits. The positioning layer's
    condition must lie clear of the config's gate. ``align_topk``: the card
    keeps the CPU's top-k choices in every soft Procrustes call
    (``topk_choices``), for a positioning layer whose cut falls on a near-tie
    whatever the draw; the entries its own choice would differ in must lie
    at that cut (``check_replayed``)."""
    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.engine.train import OptimConfig, apply_gradients, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

    limits = limits or {"loss": LOSS_REL_TOL, "worst": GRAD_WORST_TOL,
                        "median": GRAD_MEDIAN_TOL, "global": GRAD_GLOBAL_TOL,
                        "params": PARAM_ABS_TOL}
    loss_cfg = loss_cfg or LossConfig()
    gate = cfg_train.coarse_transformer.procrustes.max_condition_num
    models = {"CPU": DiffusionMatchingModel(cfg_train, device="cpu", seed=0),
              "card": DiffusionMatchingModel(cfg_train, device="cuda", seed=0)}
    if f32_cfg is not None:
        models["card f32"] = DiffusionMatchingModel(f32_cfg, device="cuda", seed=0)
    # draws whose noisy-matrix warp cuts its top-k in a wide gap
    for seed in range(first_seed, first_seed + 50):
        inputs = models["CPU"].draw_train_inputs(one, torch.Generator().manual_seed(seed))
        warp_gap = noisy_warp_cut_gap(models["CPU"], one, inputs)
        if warp_gap > CUT_GAP_MIN:
            break
    res, choices = {}, []
    cut = int(max(one.src_mask.sum(), one.tgt_mask.sum()))
    seen = {"calls": 0, "differ": 0, "far": 0}
    for name, model in models.items():
        dev = "cpu" if name == "CPU" else "cuda"
        batch = one.to(dev)
        state = create_train_state(model, OptimConfig())
        before = [p.detach().cpu().clone() for p in state.optimizer.params]
        t0 = time.perf_counter()
        if not align_topk or name == "card f32":
            aligned = contextlib.nullcontext(seen)
        elif name == "CPU":
            aligned = topk_choices(record=choices)
        else:
            aligned = topk_choices(replay=choices, cut=cut)
        with aligned as seen_here:
            out = model.train_forward(batch, **{k: v.to(dev) for k, v in inputs.items()})
        if name == "card":
            seen = seen_here
        loss, _ = diffreg_loss(out, batch, loss_cfg)
        grads = torch.autograd.grad(loss, state.optimizer.params, allow_unused=True)
        finite, _ = apply_gradients(state.optimizer, grads)
        res[name] = {"loss": float(loss.detach()), "finite": bool(finite), "out": out,
                     "grads": [None if g is None else g.cpu() for g in grads],
                     "params": [p.detach().cpu() for p in state.optimizer.params],
                     "before": before, "seconds": time.perf_counter() - t0}
    cpu, card = res["CPU"], res["card"]
    positioning = bool(cpu["out"]["position_layers"])   # none in an entangled transformer
    if positioning:
        layer = cpu["out"]["position_layers"][0]
        pos_gap = cut_gap(layer["conf_matrix"], one.src_mask, one.tgt_mask)
        cond = float(layer["condition"][0].detach())
        card_cond = float(card["out"]["position_layers"][0]["condition"][0].detach())
    else:
        pos_gap, cond, card_cond = math.inf, math.nan, math.nan
    names = [n for n, _ in models["CPU"].named_trained_parameters()]
    gap = step_gaps(card, cpu, names)
    held = "params" if "params" in limits else "update"
    log(f"train step{tag} card vs CPU (1 pair, CPU {cpu['seconds']:.1f} s): draw seed {seed}, "
        f"noisy-warp cut gap {warp_gap:.3e}, positioning cut gap {pos_gap:.3e} and condition "
        f"{cond:.3f} on the CPU, {card_cond:.3f} on the card (gate {gate:g}); loss "
        f"{card['loss']:.6f} vs {cpu['loss']:.6f} (rel err {gap['loss']:.3e}, limit "
        f"{limits['loss']:.1e}); gradients: worst tensor {gap['worst']:.3e} (limit "
        f"{limits['worst']:.1e}), median {gap['median']:.3e} (limit {limits['median']:.1e}), "
        f"global {gap['global']:.3e} (limit {limits['global']:.1e}); params after SGD "
        f"{gap['params']:.3e}, update's relative norm {gap['update']:.3e} (limit on {held} "
        f"{limits[held]:.1e})")
    log("  worst gradient tensors: " + ", ".join(f"{n} {e:.3e}" for e, n in gap["errs"][:5]))
    if align_topk:
        log(f"  the card kept the CPU's top-k choices in {seen['calls']} soft Procrustes calls: "
            f"{seen['differ']} entries of its own differ (a share {topk_share(seen, cut):.4f} "
            f"of the kept, cap {TOPK_DIFFER_SHARE}), {seen['far']} farther than "
            f"{TOPK_CUT_REL:.0e} of the cut's value from it")
        check_replayed(seen, cut, f"train step{tag}")
    if f32_cfg is not None:
        f32 = step_gaps(card, res["card f32"], names)
        log(f"  card{tag} vs card f32, same weights and draws: loss {f32['loss']:.3e}, "
            f"gradients worst {f32['worst']:.3e}, median {f32['median']:.3e}, global "
            f"{f32['global']:.3e}; update {f32['update']:.3e}")
    trained_grads_finite(models["card"], [None if g is None else g.cuda() for g in card["grads"]],
                         f"train step{tag} on the card (1 pair)")
    if not warp_gap > CUT_GAP_MIN:
        raise AssertionError(f"train step{tag}: the noisy warp's top-k cut falls on a near-tie")
    if held == "params" and positioning and not ((align_topk or pos_gap > CUT_GAP_MIN)
                                                 and abs(cond - gate) > 1.0):
        raise AssertionError(f"train step{tag}: a top-k cut or the gate falls on a near-tie")
    if not (card["finite"] and cpu["finite"]):
        raise AssertionError(f"train step{tag}: non-finite gradients")
    if not gap["loss"] <= limits["loss"]:
        raise AssertionError(f"train step{tag}: loss differs from the CPU's by {gap['loss']}")
    if not (gap["worst"] <= limits["worst"] and gap["median"] <= limits["median"]
            and gap["global"] <= limits["global"]):
        raise AssertionError(f"train step{tag}: gradients differ from the CPU's (worst "
                             f"{gap['worst']}, median {gap['median']}, global {gap['global']})")
    if not gap[held] <= limits[held]:
        raise AssertionError(f"train step{tag}: {held} differ by {gap[held]} after the update")
    return {k: v for k, v in gap.items() if k != "errs"}


def capture_step(step, state, batch, inputs):
    """One call of the train step ``step``: the loss, the gradients the update
    is handed (a parameter the loss does not reach as zeros; in a
    data-parallel step, after the all-reduce) and the parameters before and
    after, on the CPU."""
    import torch

    from diffreg_tpu_torch.engine import train

    seen = []
    original = train.apply_gradients

    def recording(optimizer, grads):
        seen.append([(torch.zeros_like(p) if g is None else g).detach().cpu().clone()
                     for g, p in zip(grads, optimizer.params)])
        return original(optimizer, grads)

    before = [p.detach().cpu().clone() for p in state.optimizer.params]
    train.apply_gradients = recording
    try:
        state, info = step(state, batch, inputs)
    finally:
        train.apply_gradients = original
    return {"loss": float(info["loss"]), "grads": seen[0], "before": before,
            "params": [p.detach().cpu().clone() for p in state.optimizer.params]}


def data_parallel_one_process(cfg_train, batch, launches):
    """Phase 21a: in a one-process NCCL group the data-parallel step on the
    4 pairs, and twice the plain step, from the same weights and draws under
    deterministic algorithms: bit for bit the same loss, gradients and
    parameters after the SGD update; 11 KPConv and the transformers'
    attention launches in the data-parallel step."""
    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.parallel.distributed import (cleanup_distributed, free_port,
                                                        setup_distributed)
    from diffreg_tpu_torch.parallel.mesh import make_parallel_train_step

    want_at = attention_calls(batch.src_mask.shape[1], batch.tgt_mask.shape[1],
                              tuple(cfg_train.coarse_transformer.layer_types)
                              + tuple(cfg_train.denoising_layer_types))
    model = DiffusionMatchingModel(cfg_train, device="cuda", seed=0)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    inputs = model.draw_train_inputs(batch, torch.Generator("cuda").manual_seed(0))
    setup_distributed(init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1,
                      local_rank=0)
    runs, seconds = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, step in (("plain", make_train_step(LossConfig())),
                           ("plain again", make_train_step(LossConfig())),
                           ("data-parallel", make_parallel_train_step(LossConfig()))):
            model.load_state_dict(weights)
            state = create_train_state(model, OptimConfig())
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            runs[name], seconds[name] = wall(lambda: capture_step(step, state, batch, inputs))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if (n_kp, n_at) != (11, want_at):
                raise AssertionError(f"data parallel, one process ({name}): {n_kp} KPConv and "
                                     f"{n_at} attention launches (want 11 and {want_at})")
            if name == "data-parallel":
                launches["kpconv_dp"] += n_kp
                launches["masked_attention_dp"] += n_at
    finally:
        torch.use_deterministic_algorithms(False)
        cleanup_distributed()

    def differing(a, b):
        """Tensors (gradients, then parameters) of runs a and b that differ in a bit."""
        return [f"{kind} {i}" for kind in ("grads", "params")
                for i, (x, y) in enumerate(zip(a[kind], b[kind])) if not torch.equal(x, y)]

    plain = runs["plain"]
    repeat, parallel = differing(plain, runs["plain again"]), differing(plain,
                                                                        runs["data-parallel"])
    log(f"data parallel, one process (NCCL, {batch.batch_size} pairs, gate "
        f"{cfg_train.procrustes.max_condition_num:g}, deterministic algorithms): loss plain "
        f"{plain['loss']!r}, again {runs['plain again']['loss']!r}, data-parallel "
        f"{runs['data-parallel']['loss']!r}; tensors differing from the plain step: plain "
        f"again {len(repeat)}, data-parallel {len(parallel)} of {2 * len(plain['grads'])}; "
        f"seconds " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; launches kpconv 11 attention {want_at}")
    if repeat or plain["loss"] != runs["plain again"]["loss"]:
        raise AssertionError(f"data parallel, one process: the plain step does not repeat "
                             f"itself bit for bit ({repeat[:5]})")
    if parallel or plain["loss"] != runs["data-parallel"]["loss"]:
        raise AssertionError(f"data parallel, one process: the data-parallel step differs "
                             f"from the plain step ({parallel[:5]})")
    return {"seconds": seconds, "launches": {"kpconv": 11, "masked_attention": want_at}}


def _data_parallel_rank(rank, world, case, ref_path):
    """A process of phase 21b (spawned: this file is its main module): the
    data-parallel step on its pair of the batch; its launches, and its
    gradients and parameters against the plain step's (``step_gaps``)."""
    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.parallel.mesh import make_parallel_train_step, shard_rows

    model = DiffusionMatchingModel(case["cfg"], device="cuda", seed=0)
    state = create_train_state(model, OptimConfig())
    rows = shard_rows(case["batch"].batch_size, rank, world)
    batch = case["batch"].select(rows).to("cuda")
    inputs = {k: v[rows].cuda() for k, v in case["inputs"].items()}
    kpconv_cuda.launches = 0
    masked_attention_cuda.launches = 0
    got, seconds = wall(lambda: capture_step(make_parallel_train_step(LossConfig()), state,
                                             batch, inputs))
    counts = (kpconv_cuda.launches, masked_attention_cuda.launches)
    gap = step_gaps(got, torch.load(ref_path, weights_only=False),
                    [n for n, _ in model.named_trained_parameters()])
    return {"launches": counts, "loss": got["loss"], "seconds": seconds,
            "gap": {k: v for k, v in gap.items() if k != "errs"}, "worst": gap["errs"][:3],
            "fingerprint": [float(p.double().sum()) for p in got["params"]]}


def data_parallel_two_processes(cfg_train, batch_cpu, launches):
    """Phase 21b: two processes on the card (gloo), a pair each, against the
    plain step on both pairs from the same weights and draws: the loss, every
    gradient and the parameters after the update at phase 8's f32 limits; the
    same parameters in both processes; each process's launches."""
    import tempfile

    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.parallel.distributed import run_ranks

    pairs = batch_cpu.select(slice(0, DP_PAIRS))
    want_at = attention_calls(pairs.src_mask.shape[1], pairs.tgt_mask.shape[1],
                              tuple(cfg_train.coarse_transformer.layer_types)
                              + tuple(cfg_train.denoising_layer_types))
    model = DiffusionMatchingModel(cfg_train, device="cuda", seed=0)
    inputs = model.draw_train_inputs(pairs, torch.Generator().manual_seed(0))
    ref = capture_step(make_train_step(LossConfig()), create_train_state(model, OptimConfig()),
                       pairs.to("cuda"), {k: v.cuda() for k, v in inputs.items()})
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "plain.pt")
        torch.save(ref, ref_path)
        t0 = time.perf_counter()
        ranks = run_ranks(_data_parallel_rank, DP_PAIRS,
                          ({"cfg": cfg_train, "batch": pairs, "inputs": inputs}, ref_path),
                          cards=[0] * DP_PAIRS, backend="gloo", timeout_s=DP_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
    limits = {"loss": LOSS_REL_TOL, "worst": GRAD_WORST_TOL, "median": GRAD_MEDIAN_TOL,
              "global": GRAD_GLOBAL_TOL, "params": PARAM_ABS_TOL}
    for rank, res in enumerate(ranks):
        gap = res["gap"]
        log(f"data parallel, two processes on the card (gloo), process {rank}: loss "
            f"{res['loss']:.6f} vs plain {ref['loss']:.6f} (rel err {gap['loss']:.3e}); "
            f"gradients worst {gap['worst']:.3e} median {gap['median']:.3e} global "
            f"{gap['global']:.3e}; params after SGD {gap['params']:.3e}; step "
            f"{res['seconds']:.3f} s; launches kpconv {res['launches'][0]} attention "
            f"{res['launches'][1]}; worst tensors "
            + ", ".join(f"{n} {e:.2e}" for e, n in res["worst"]))
        if res["launches"] != (11, want_at):
            raise AssertionError(f"data parallel, process {rank}: launches {res['launches']} "
                                 f"(want 11 and {want_at})")
        for key, limit in limits.items():
            if not gap[key] <= limit:
                raise AssertionError(f"data parallel, process {rank}: {key} {gap[key]} against "
                                     f"the plain step (limit {limit})")
        launches["kpconv_dp"] += res["launches"][0]
        launches["masked_attention_dp"] += res["launches"][1]
    if ranks[0]["fingerprint"] != ranks[1]["fingerprint"]:
        raise AssertionError("data parallel: the two processes' parameters differ after the step")
    log(f"data parallel, two processes: {spawn_s:.1f} s with the spawn; the same parameters "
        "in both after the update")
    return {"spawn_s": spawn_s, "gaps": [r["gap"] for r in ranks],
            "step_s": [r["seconds"] for r in ranks]}


def deformable_data():
    """The 4DMatch phase's data: BATCH_PAIRS deformable pairs of N_POINTS at
    scene scale SCALE_4D (4DMatch's 0.01 voxel), the spec calibrated from two
    more such pairs as main.py calibrates (its sides' token counts differ),
    their pyramid batch, each pair's metric points (raw source, GT flow, a
    seeded metric_index) and the raw pairs (src, tgt, rot, trn, flow)."""
    import numpy as np

    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.data.pyramid import PyramidConfig, batch_from_samples, build_pair_pyramid
    from diffreg_tpu_torch.data.synthetic import make_pair

    pair = lambda rng: make_pair(rng, N_POINTS, deformable=True, flow_amp=FLOW_AMP_4D,
                                 scale=SCALE_4D)
    # configs/test/4dmatch.yaml:9,22
    pcfg = PyramidConfig(first_subsampling_dl=0.01, coarse_match_radius=0.024)
    cal_rng = np.random.RandomState(0)
    spec = calibrate_spec([pair(cal_rng)[:2] for _ in range(2)], pcfg, k_cap=40,
                          neighbor_percentile=90.0)
    rng, pick = np.random.RandomState(1), np.random.RandomState(2)
    samples, meta, pairs = [], [], []
    for _ in range(BATCH_PAIRS):
        pairs.append(pair(rng))
        src, tgt, rot, trn, flow = pairs[-1]
        samples.append(build_pair_pyramid(src, tgt, rot, trn, pcfg, spec, scene_flow=flow))
        idx = np.sort(pick.choice(len(src), min(len(src), METRIC_POINTS), replace=False))
        meta.append({"src_pcd": src, "scene_flow": flow, "metric_index": idx})
    return batch_from_samples(samples), meta, spec, pairs


def run_4dmatch(batch_cpu, meta, spec, launches):
    """Phase 9: the 4DMatch path at full width through FourDMatchTester, then
    pair 0 on the CPU (phase 10). Returns the numbers for the summary."""
    import torch

    from diffreg_tpu_torch.engine.tester import (FourDMatchTester, TestConfig,
                                                 make_metric_points_fn, match_mask_4dmatch,
                                                 pair_metrics_4dmatch)
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_4dmatch
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    cfg = preset_4dmatch(sample_steps=STEPS)
    per_step = attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    model = DiffusionMatchingModel(cfg, device="cuda", seed=0)
    tcfg = TestConfig(inlier_thr=0.04, match_thr=MATCH_THR_4D)
    tester = FourDMatchTester(model, tcfg, device="cuda")
    metric_points = make_metric_points_fn(METRIC_POINTS)
    batch = batch_cpu.to("cuda")
    make_iter = lambda: iter([(batch, meta)])
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        tester.test(make_iter, torch.Generator("cuda").manual_seed(0), metric_points)  # warm-up
        times = []
        for run in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            summary, seconds = wall(lambda: tester.test(
                make_iter, torch.Generator("cuda").manual_seed(1 + run), metric_points))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 11 or n_at != per_step * STEPS:
                raise AssertionError(f"4DMatch tester: {n_kp} KPConv launches (want 11), "
                                     f"{n_at} attention launches (want {per_step * STEPS})")
            launches["kpconv"] += n_kp
            launches["masked_attention_d132"] += n_at
            times.append(seconds)
            if not (summary["pairs"] == BATCH_PAIRS and summary["matches"] > 0
                    and math.isfinite(summary["IR"])
                    and math.isfinite(summary.get("NFMR", math.nan))):
                raise AssertionError(f"4DMatch tester summary {summary}")
        seconds = sorted(times)[TIMED_RUNS // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"4DMatch path (FourDMatchTester, gate 40, stochastic DDIM, {STEPS} steps, match "
            f"threshold {MATCH_THR_4D}): {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = {BATCH_PAIRS / seconds:.3f} pairs/s; "
            f"IR {summary['IR']:.4f} NFMR {summary['NFMR']:.4f}, {summary['matches']:.1f} "
            f"matches a pair; launches kpconv {n_kp} "
            f"attention {n_at}; peak memory {peak:.2f} GiB")

        # ---- 10. pair 0 on the CPU, same weights and draws ----
        gen = torch.Generator().manual_seed(3)
        x_init = torch.randn(BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
        noise = torch.randn(STEPS, BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        out, fwd_s = wall(lambda: model.ddim_sample(batch, x_init.cuda(),
                                                    ddim_noise=noise.cuda()))
        n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
        if n_kp != 11 or n_at != per_step * STEPS:
            raise AssertionError(f"4DMatch ddim_sample: {n_kp} KPConv, {n_at} attention launches")
        launches["kpconv"] += n_kp
        launches["masked_attention_d132"] += n_at
        cond = out["step_condition"]
        accepted = int((cond < cfg.procrustes.max_condition_num).sum())
        log(f"4DMatch ddim_sample: {fwd_s:.4f} s, warps accepted {accepted}/{cond.numel()}")
        cpu_model = DiffusionMatchingModel(cfg, device="cpu", seed=0)
        one = batch_cpu.select(slice(0, 1))
        t0 = time.perf_counter()
        ref = cpu_model.ddim_sample(one, x_init[:1], ddim_noise=noise[:, :1])
        cpu_s = time.perf_counter() - t0
        valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
        got = {k: v[:1].cpu() for k, v in out.items() if k != "step_condition"}
        conf_err = float((got["conf_matrix_pred"] - ref["conf_matrix_pred"]).abs()[valid].max())
        pose_err = max(float((got[k] - ref[k]).abs().max())
                       for k in ("rotation_pred", "translation_pred"))
        gap = cut_gap(ref["conf_matrix_pred"], one.src_mask, one.tgt_mask)
        mask, ref_mask = (match_mask_4dmatch(o, one, tcfg) for o in (got, ref))
        agree = float((mask == ref_mask)[valid].float().mean())
        ir, n_corr = pair_metrics_4dmatch(got, one, tcfg)
        ref_ir, ref_n = pair_metrics_4dmatch(ref, one, tcfg)
        cpu_tester = FourDMatchTester(cpu_model, tcfg, device="cpu")
        nfmr = cpu_tester.nfmr_for_batch(got, one, meta[:1], metric_points)[0]
        ref_nfmr = cpu_tester.nfmr_for_batch(ref, one, meta[:1], metric_points)[0]
        cond_cpu = ref["step_condition"][:, 0]
        cond_gap = float((cond_cpu - cfg.procrustes.max_condition_num).abs().min())
    log(f"4DMatch card vs CPU, pair 0 (CPU {cpu_s:.1f} s): sigmoid conf {conf_err:.3e} (limit "
        f"{CONF_4D_ABS_TOL:.0e}), pose {pose_err:.3e} (limit {POSE_ABS_TOL:.0e}), cut gap "
        f"{gap:.3e}, nearest step condition to the gate {cond_gap:.3f}, thr-mutual mask "
        f"agreement {agree:.7f}, matches {int(n_corr[0])} vs {int(ref_n[0])}, IR "
        f"{float(ir[0]):.5f} vs {float(ref_ir[0]):.5f}, NFMR {nfmr:.5f} vs {ref_nfmr:.5f}")
    if not gap > CUT_GAP_MIN:
        raise AssertionError(f"4DMatch: soft Procrustes' cut falls on a near-tie ({gap})")
    if not conf_err <= CONF_4D_ABS_TOL:
        raise AssertionError(f"4DMatch: confidences differ from the CPU's by {conf_err}")
    if not pose_err <= POSE_ABS_TOL:
        raise AssertionError(f"4DMatch: pose differs from the CPU's by {pose_err}")
    if not agree >= MASK_AGREEMENT:
        raise AssertionError(f"4DMatch: thr-mutual masks agree on {agree} of entries")
    if not (abs(float(ir[0]) - float(ref_ir[0])) <= METRIC_4D_ABS_TOL
            and abs(nfmr - ref_nfmr) <= METRIC_4D_ABS_TOL):
        raise AssertionError("4DMatch: IR or NFMR differ from the CPU's")
    return {"pairs_per_s": BATCH_PAIRS / seconds, "peak_gib": peak}


def write_4dmatch_split(directory, pairs, meta):
    """The pairs as 4DMatch .npz entries (src_pcd, tgt_pcd, s2t_flow, rot,
    trans, metric_index), as data/datasets.py:FourDMatchPairDataset reads them."""
    import numpy as np

    os.makedirs(directory)
    for i, ((src, tgt, rot, trn, flow), m) in enumerate(zip(pairs, meta)):
        np.savez(os.path.join(directory, f"pair{i}.npz"), src_pcd=src, tgt_pcd=tgt,
                 s2t_flow=flow, rot=rot, trans=trn, metric_index=m["metric_index"][:, None])


def run_cli(repo, pairs4, meta4, launches):
    """Phase 11: ``diffreg_tpu_torch.main`` on the card, in a temporary working
    directory: 4DMatch test on the demo pairs at the protocol's threshold;
    4DMatch test on the 4DMatch phase's pairs written as an on-disk split,
    with a checkpoint of random weights (calibration from the YAML's pyramid,
    the loader, the restore, NFMR on the metric_index points) at MATCH_THR_4D;
    3DMatch test (65,536 RANSAC hypotheses); one 4DMatch training epoch (its
    config with max_epoch cut to 1)."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.data.datasets import FourDMatchPairDataset
    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import create_train_state
    from diffreg_tpu_torch.main import data_spec
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import (build_optim_config, build_pipeline_config,
                                                load_yaml)

    configs = os.path.join(repo, "configs")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        train_cfg = load_yaml(os.path.join(configs, "train", "4dmatch.yaml"))
        train_cfg["max_epoch"] = 1
        with open(os.path.join(tmp, "train_4dmatch.yaml"), "w") as f:
            yaml.safe_dump(train_cfg, f)
        disk_cfg = load_yaml(os.path.join(configs, "test", "4dmatch.yaml"))
        write_4dmatch_split(os.path.join(tmp, "4dmatch", "test"), pairs4, meta4)
        disk_cfg.update(data_root=os.path.join(tmp, "4dmatch"), exp_dir="disk-4dmatch",
                        split={"test": os.path.join(tmp, "4dmatch", "test")},
                        pretrain=os.path.join(tmp, "ckpt"), num_workers=4)
        pipeline = build_pipeline_config(disk_cfg)
        CheckpointManager(disk_cfg["pretrain"]).save(1, create_train_state(
            DiffusionMatchingModel(pipeline, device="cpu", seed=0),
            build_optim_config(disk_cfg, steps_per_epoch=1)))
        with open(os.path.join(tmp, "disk_4dmatch.yaml"), "w") as f:
            yaml.safe_dump(disk_cfg, f)
        disk_spec, _ = data_spec(FourDMatchPairDataset(disk_cfg["split"]["test"]), disk_cfg,
                                 pipeline)
        _, demo_spec, _ = synthetic_batch(batch_size=1, n_points=768, seed=0)
        layers = pipeline.denoising_layer_types
        ddim = lambda spec: STEPS * attention_calls(spec.n_src, spec.n_tgt, layers)
        train = attention_calls(demo_spec.n_src, demo_spec.n_tgt,
                                tuple(pipeline.coarse_transformer.layer_types) + layers)
        # (name, config, extra arguments, pairs per batch, summary keys, attention
        # launches per batch: a 20-step DDIM sample or a train step)
        runs = [("4DMatch test (demo)", os.path.join(configs, "test", "4dmatch.yaml"),
                 ["--demo", "--thr", "0.55"], BATCH_PAIRS, ("IR",), ddim(demo_spec)),
                ("4DMatch test (on disk)", os.path.join(tmp, "disk_4dmatch.yaml"),
                 ["--thr", str(MATCH_THR_4D)], BATCH_PAIRS, ("IR", "NFMR", "matches"),
                 ddim(disk_spec)),
                ("3DMatch test (demo)", os.path.join(configs, "test", "3dmatch.yaml"), ["--demo"],
                 BATCH_PAIRS, ("IR", "FMR", "RR"), ddim(demo_spec)),
                ("4DMatch train (demo)", os.path.join(tmp, "train_4dmatch.yaml"),
                 ["--demo", "--mode", "train"], 2, ("loss",), train)]
        os.chdir(tmp)
        try:
            for name, config, extra, batch_size, keys, attn_per_batch in runs:
                kpconv_cuda.launches = 0
                masked_attention_cuda.launches = 0
                argv = ["--config", config, "--num-pairs", str(BATCH_PAIRS),
                        "--batch-size", str(batch_size), *extra]
                summary, seconds = wall(lambda: cli(argv))
                n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
                batches = BATCH_PAIRS // batch_size
                if n_kp != 11 * batches or n_at != attn_per_batch * batches:
                    raise AssertionError(f"main {name}: {n_kp} KPConv, {n_at} attention launches")
                if not all(math.isfinite(summary[k]) for k in keys):
                    raise AssertionError(f"main {name}: summary {summary}")
                if "matches" in keys and not summary["matches"] > 0:
                    raise AssertionError(f"main {name}: no match extracted ({summary})")
                launches["kpconv"] += n_kp
                launches["masked_attention_d132" if "4DMatch" in name
                         else "masked_attention"] += n_at
                log(f"main {name}, {BATCH_PAIRS} pairs: {seconds:.2f} s, launches kpconv "
                    f"{n_kp} attention {n_at}; " + ", ".join(
                        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in summary.items()))
            log(f"main 4DMatch on-disk spec {disk_spec}")
            if not os.path.isfile(os.path.join(tmp, "snapshot", "train-4dmatch", "checkpoints",
                                               "1.pt")):
                raise AssertionError("main 4DMatch train: no checkpoint")
        finally:
            os.chdir(cwd)


# ---------------------------------------------------------------- bf16


def bf16_pair_check(got, ref, f32, one, cpu_model, tag, solve_choices=None, cut=None,
                    hold=True):
    """Pair 0 of the card's bf16 DDIM against the CPU's (the same roundings,
    so they differ where f32 sums in another order flip a bf16 rounding):
    the confidences within CONF_BF16_REL_TOL of the largest; the union mask
    agreeing on MASK_BF16_AGREEMENT of the valid entries, and differing only in
    rows or columns whose best two CPU confidences lie within twice that
    limit (near-ties); the pose solve on the card's confidences against the
    CPU's solve of the same confidences within POSE_ABS_TOL. With random
    weights the confidences are near-uniform, so soft Procrustes amplifies
    their card-vs-CPU difference into the end-to-end pose: that gap, and the
    card's bf16-vs-f32 gaps, are printed beside the limits. With
    ``solve_choices`` (the top-k choices the card's final Procrustes call
    kept, recorded on the CPU: ``topk_choices``) the CPU's solve keeps them
    too. With ``hold`` false the readings are printed and nothing is held."""
    import torch

    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    conf = ref["conf_matrix_pred"]
    top = float(conf[valid].max())
    limit = CONF_BF16_REL_TOL * top
    card = got["conf_matrix_pred"][:1].cpu()
    conf_err = float((card - conf).abs()[valid].max())
    f32_gap = float((card - f32["conf_matrix_pred"][:1].cpu()).abs()[valid].max())
    pose_gap = lambda a, b: max(float((a[k][:1].cpu() - b[k][:1].cpu()).abs().max())  # noqa: E731
                                for k in ("rotation_pred", "translation_pred"))
    with (topk_choices(replay=solve_choices, cut=cut) if solve_choices
          else contextlib.nullcontext()):
        solve = cpu_model._pose(card, ref["s_pcd"], ref["t_pcd"], one.src_mask, one.tgt_mask)
    solve_err = pose_gap(got, {"rotation_pred": solve.rotation,
                               "translation_pred": solve.translation})
    c = torch.where(valid, conf, torch.full_like(conf, -1.0))
    top_r, top_c = c.topk(2, dim=2).values, c.topk(2, dim=1).values
    row_tie = (top_r[..., 0] - top_r[..., 1]) <= 2 * limit                    # [1, S]
    col_tie = (top_c[:, 0] - top_c[:, 1]) <= 2 * limit                        # [1, T]
    differ = (got["corr_mask"][:1].cpu() != ref["corr_mask"]) & valid
    agree = 1.0 - float(differ.sum()) / float(valid.sum())
    unexplained = int((differ & ~(row_tie[:, :, None] | col_tie[:, None, :])).sum())
    real = one.src_mask[0]
    tie_free = float((~row_tie[0] & real).sum()) / max(int(real.sum()), 1)
    log(f"bf16 card vs CPU {tag}: conf {conf_err:.3e} (limit {limit:.3e}, max conf {top:.3e}; "
        f"card bf16 vs card f32 {f32_gap:.3e}); corr_mask agreement {agree:.6f} (limit "
        f"{MASK_BF16_AGREEMENT}), {int(differ.sum())} of {int(valid.sum())} entries differ, "
        f"{unexplained} outside a near-tie (limit 0), real rows free of a near-tie "
        f"{tie_free:.4f}; pose solve on the card's confidences vs the CPU's {solve_err:.3e} "
        f"(limit {POSE_ABS_TOL:.0e}); end-to-end pose card vs CPU {pose_gap(got, ref):.3e}, "
        f"card bf16 vs f32 {pose_gap(got, f32):.3e}")
    if hold and not (conf_err <= limit and agree >= MASK_BF16_AGREEMENT and unexplained == 0
                     and solve_err <= POSE_ABS_TOL):
        raise AssertionError(f"bf16 {tag}: conf {conf_err}, mask agreement {agree}, "
                             f"{unexplained} entries outside a near-tie, pose solve {solve_err}")


def bf16_edge_cases(gen):
    """Both bf16 kernels against their plain bf16 versions, at the limits of
    the main-path check, where the new tilings and splits have edges:
    attention at L x S of 70 x 45, 1 x 768 and 768 x 1, with a batch row
    whose key mask holds one valid key, and at S = 1500 (a block's key range
    past the kept-logits limit: the recompute branch), at both head widths;
    KPConv at K = 1 and K = 40, Nq short of one 32-query tile, grids short of
    two waves (the kernel-point split on) and long (off), and Cin = 32 and
    512. Returns (attention cases, KPConv cases)."""
    import torch

    from diffreg_tpu_torch.ops.attention import (masked_attention_bf16_plain,
                                                 masked_attention_cuda_bf16)

    att = []
    with torch.inference_mode():
        for d in (108, 132):
            for name, b, length, keys, one_valid in (
                    ("70x45", 2, 70, 45, False), ("1x768", 2, 1, 768, False),
                    ("768x1", 2, 768, 1, False), ("one valid key", 2, 704, 704, True),
                    ("recompute 1500", 2, 300, 1500, False)):
                q = torch.randn(b, 4, length, d, generator=gen).to("cuda", torch.bfloat16)
                k, v = (torch.randn(b, 4, keys, d, generator=gen).to("cuda", torch.bfloat16)
                        for _ in range(2))
                mask = torch.arange(keys)[None] < torch.tensor([keys, max(keys - 37, 1)])[:, None]
                if one_valid:
                    mask[0] = False
                    mask[0, keys // 2] = True
                mask = mask.cuda()
                got = masked_attention_cuda_bf16(q, k, v, mask, d ** -0.5).float()
                ref = masked_attention_bf16_plain(q, k, v, mask, d ** -0.5).float()
                err, top = float((got - ref).abs().max()), float(ref.abs().max())
                log(f"attention bf16 edge {name}, D {d}: err {err:.3e} = {err / top:.3e} of max "
                    f"|plain| (limit {ATTENTION_BF16_REL_TOL:.0e})")
                if not math.isfinite(err) or err > ATTENTION_BF16_REL_TOL * top:
                    raise AssertionError(f"attention bf16 edge {name}, D {d}: err {err}")
                att.append({"case": name, "d": d, "l": length, "s": keys, "max_abs_err": err,
                            "max_abs_plain": top})
    return att, kpconv_edge_cases(gen, bf16=True)


def kpconv_edge_cases(gen, bf16=False, modes=("linear", "sum")):
    """The KPConv kernel (``bf16``: its bf16 instance) in ``modes`` against its
    plain version where its tilings and splits have edges (bf16_edge_cases's
    KPConv shapes), at the main-path check's limits. Returns the cases."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)

    kp = []
    mode = "" if modes == ("linear", "sum") else " " + "/".join(modes)
    tag = f"kpconv{' bf16' if bf16 else ''}{mode}"
    with torch.inference_mode():
        for name, b, nq, ns, k, cin, cout in (
                ("K 1, split off", 4, 8704, 8704, 1, 64, 64),
                ("K 40, split on", 4, 1536, 1536, 40, 128, 128),
                ("Nq 20 (short of a tile)", 4, 20, 300, 40, 64, 64),
                ("Nq 5, K 7, Cin 32", 1, 5, 40, 7, 32, 128),
                ("Cin 32, split off", 4, 8704, 8704, 34, 32, 64),
                ("Cin 512, K 16, split on", 2, 300, 1000, 16, 512, 512),
                ("Cin 512, split off", 4, 4352, 4352, 40, 512, 64)):
            s_pts = torch.rand(b, ns, 3, generator=gen) * 2.0 + torch.tensor([3.2, -2.1, 1.7])
            q_pts = s_pts[:, torch.randint(0, ns, (nq,), generator=gen)] + \
                0.01 * torch.randn(b, nq, 3, generator=gen)
            inds = torch.randint(0, ns + 1, (b, nq, k), generator=gen).int()
            x = torch.randn(b, ns, cin, generator=gen)
            kpts = torch.randn(15, 3, generator=gen) * 0.3
            w = torch.randn(15, cin, cout, generator=gen) * 0.05
            q_pts, s_pts, inds, x, kpts, w = (t.cuda().contiguous()
                                               for t in (q_pts, s_pts, inds, x, kpts, w))
            if bf16:
                got = kpconv_cuda_bf16(q_pts, kpconv_bf16_table_aligned(s_pts, x), inds, kpts,
                                       w.to(torch.bfloat16).contiguous(), 0.6, *modes)
                ref = kpconv_bf16_plain(q_pts, s_pts, inds, x, kpts, w, 0.6, *modes)
            else:
                got = kpconv_cuda(q_pts, s_pts, inds, x, kpts, w, 0.6, *modes)
                ref = kpconv(q_pts, s_pts, inds, x, kpts, w, 0.6, *modes)
            top = float(ref.abs().max())
            limit = KPCONV_BF16_REL_TOL if bf16 else KPCONV_REL_TOL
            allowed = limit * (top if bf16 else max(top, 1.0))
            err, excused = held_against_plain(got, ref, allowed, f"{tag} edge {name}", modes[1],
                                              (q_pts, s_pts, inds, kpts, bf16))
            log(f"{tag} edge {name} (B {b}, Nq {nq}, K {k}, {cin}->{cout}): err {err:.3e} "
                f"= {err / top:.3e} of max |plain| (limit {limit:.0e}"
                f"{f'; {excused} near-tie rows excused' if excused else ''})")
            kp.append({"case": name, "b": b, "nq": nq, "k": k, "cin": cin, "cout": cout,
                       "max_abs_err": err, "max_abs_plain": top, "excused_rows": excused})
    return kp


def profile_call(repo, fn):
    """One call of ``fn`` (ending in a synchronize) under torch.profiler,
    summarised by tools/profile_port.py:summarize: wall time, the device's
    busy time and idle share, kernel launches and the top kernels."""
    import importlib.util
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location(
        "profile_port", os.path.join(repo, "tools", "profile_port.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return module.summarize(path, wall_s)


def run_bf16(repo, batch, batch_cpu, spec, x_init, u, f32_ref, batch4_cpu, gen, launches):
    """Phase 8b, the bf16 fast path (configs/test/3dmatch_fast.yaml): each
    bf16 instance against its plain bf16 version at the main path's shapes
    (KPConv at the 11 layers of a bf16 encode, attention at the 3DMatch self
    and cross shapes, D = 108, and the 4DMatch ones, D = 132), with SDPA in
    bf16 as the attention yardstick, and at the edges of their tilings
    (``bf16_edge_cases``); the bf16 DDIM at full width, gate 0 and
    40 (one warm-up and three timed runs, the bf16 launches asserted and no
    f32 kernel launched), pair 0 against the CPU, and ``main`` on
    3dmatch_fast.yaml with --demo. Returns the two kernels' JSON entries and
    pairs/s per gate."""
    import tempfile

    import torch

    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import (preset_3dmatch, preset_4dmatch,
                                                  with_condition_gate, with_fast_path)
    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16

    cfg = with_fast_path(preset_3dmatch(sample_steps=STEPS))
    models = {gate: DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cuda", seed=0)
              for gate in GATES}
    kp, kp_shapes = check_kpconv(kpconv_layer_calls(models[0.0],
                                                    lambda: models[0.0].encode(batch), KPConv),
                                 11, "one encode (11 calls)", " (bf16)", bf16=True)
    at = check_attention(batch, cfg, gen, " (bf16)", bf16=True)
    cfg4 = with_fast_path(preset_4dmatch(sample_steps=STEPS))
    batch4 = batch4_cpu.to("cuda")
    at4 = check_attention(batch4, cfg4, gen, " (bf16, 4DMatch)", bf16=True)
    at["d132"] = {k: at4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "per")}
    # the gradients through the bf16 instances' Functions (backward: the plain
    # bf16 recompute) against plain bf16 autograd, at the same shapes
    worst, ms = kpconv_gradients(kp_shapes, gen, bf16=True)
    kp.update({"backward_ms": ms, "backward_route": "plain recompute",
               "backward_max_rel_err": worst})
    del kp_shapes
    worst, ms = attention_gradients(batch, cfg, gen, bf16=True)
    at.update({"backward_ms": ms, "backward_route": "plain recompute",
               "backward_max_rel_err": worst})
    worst, ms = attention_gradients(batch4, cfg4, gen, bf16=True)
    at["d132"].update({"backward_ms": ms, "backward_max_rel_err": worst})
    del batch4
    at["shapes"] += at4["shapes"]
    at["max_abs_err"] = max(at["max_abs_err"], at4["max_abs_err"])
    at["edge_cases"], kp["edge_cases"] = bf16_edge_cases(gen)

    torch.cuda.reset_peak_memory_stats()
    per_step = attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    pairs_per_s, outs, profiles = {}, {}, {}
    for gate, model in models.items():
        register(model, batch, x_init, u)                      # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            for fn in (kpconv_cuda, masked_attention_cuda, kpconv_cuda_bf16,
                       masked_attention_cuda_bf16):
                fn.launches = 0
            kpconv_cuda_bf16.route_launches = {}
            out, seconds = wall(lambda: register(model, batch, x_init, u))
            n_kp, n_at = kpconv_cuda_bf16.launches, masked_attention_cuda_bf16.launches
            f32 = kpconv_cuda.launches + masked_attention_cuda.launches
            routes = dict(kpconv_cuda_bf16.route_launches)
            if n_kp != 11 or n_at != per_step * STEPS or f32 or routes != ENCODE_ROUTES:
                raise AssertionError(f"bf16 gate {gate}: {n_kp} bf16 KPConv launches (want "
                                     f"11) by route {routes} (want {ENCODE_ROUTES}), {n_at} "
                                     f"bf16 attention (want {per_step * STEPS}), {f32} f32 "
                                     "kernel launches (want 0)")
            launches["kpconv_bf16"] += n_kp
            launches["kpconv_bf16_any_shape"] += routes["any_shape_tensor_cores"]
            launches["masked_attention_bf16"] += n_at
            times.append(seconds)
        seconds = sorted(times)[TIMED_RUNS // 2]
        check_outputs(out, f"bf16 gate {gate}")
        pairs_per_s[gate] = BATCH_PAIRS / seconds
        outs[gate] = {k: out[k][:1] for k in ("conf_matrix_pred", "corr_mask", "rotation_pred",
                                              "translation_pred")}
        with torch.inference_mode():
            _, enc_s = wall(lambda: model.encode(batch))
            _, ddim_s = wall(lambda: model.ddim_sample(batch, x_init.cuda()))
        cond = out.get("step_condition")
        accepted = "" if cond is None else \
            f", warps accepted {int((cond < gate).sum())}/{cond.numel()}"
        log(f"bf16 path gate {gate}: {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = {pairs_per_s[gate]:.3f} pairs/s "
            f"(f32 path {f32_ref[gate]['pairs_per_s']:.3f}); encode {enc_s:.4f} s, DDIM "
            f"{ddim_s - enc_s:.4f} s; launches bf16 kpconv {n_kp} attention {n_at}, f32 0"
            f"{accepted}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        prof = profile_call(repo, lambda: register(model, batch, x_init, u))
        profiles[str(gate)] = {k: prof[k] for k in ("wall_s", "device_busy_s", "idle_share",
                                                    "kernel_launches", "top_kernels_ms")}
        log(f"bf16 path gate {gate}, one profiled call: wall {prof['wall_s']:.4f} s, device "
            f"busy {prof['device_busy_s']:.4f} s, idle share {prof['idle_share']:.3f}, "
            f"{prof['kernel_launches']} kernel launches "
            f"({prof['kernel_launches'] / STEPS:.0f} per DDIM step); top kernels (ms): "
            + "; ".join(f"{ms:.3f} {name}" for name, ms in prof["top_kernels_ms"][:6]))
    gated = models[40.0]
    del models

    one = batch_cpu.select(slice(0, 1))
    cut = int(max(one.src_mask.sum(), one.tgt_mask.sum()))
    for gate in GATES:
        t0 = time.perf_counter()
        cpu_model = DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cpu", seed=0)
        if gate == 0.0:
            ref = register(cpu_model, one, x_init[:1], u[:1], device="cpu")
            bf16_pair_check(outs[gate], ref, f32_ref[gate], one, cpu_model,
                            f"gate {gate} (CPU {time.perf_counter() - t0:.1f} s)")
            continue
        # At gate 40 the warp's soft Procrustes cuts its top-k among the flat
        # random-weight confidences, where the CPU's bf16 values tie exactly and
        # the card's differ by a rounding: pair 0 runs again on the card keeping
        # the CPU's top-k choices, as phases 22 and 23c hold their gate-40
        # DDIMs, and each choice of its own that differs must lie at the cut
        choices = []
        with topk_choices(record=choices):
            ref = register(cpu_model, one, x_init[:1], u[:1], device="cpu")
        # the timed run's pair 0, on the card's own top-k choices, beside the
        # CPU: printed, so that a kernel's drift at this gate stays in view
        bf16_pair_check(outs[gate], ref, f32_ref[gate], one, cpu_model,
                        f"gate {gate}, the card's own top-k choices (printed, not held)",
                        hold=False)
        with topk_choices(replay=choices, cut=cut) as seen:
            got = register(gated, one.to("cuda"), x_init[:1].cuda(), u[:1].cuda())
        tag = f"gate {gate}"
        bf16_pair_check(got, ref, f32_ref[gate], one, cpu_model,
                        f"{tag} (CPU {time.perf_counter() - t0:.1f} s; the CPU's top-k choices "
                        f"in {seen['calls']} Procrustes calls: {seen['differ']} entries of the "
                        f"card's own differ, {seen['far']} farther than {TOPK_CUT_REL:.0e} of "
                        "the cut)", solve_choices=choices[-1:], cut=cut)
        check_replayed(seen, cut, f"bf16 {tag}")
    del gated

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for fn in (kpconv_cuda, masked_attention_cuda, kpconv_cuda_bf16,
                       masked_attention_cuda_bf16):
                fn.launches = 0
            config = os.path.join(repo, "configs", "test", "3dmatch_fast.yaml")
            summary, seconds = wall(lambda: cli(["--config", config, "--demo", "--num-pairs",
                                                 str(BATCH_PAIRS), "--batch-size",
                                                 str(BATCH_PAIRS)]))
        finally:
            os.chdir(cwd)
    from diffreg_tpu_torch.data.synthetic import synthetic_batch

    _, demo_spec, _ = synthetic_batch(batch_size=1, n_points=768, seed=0)
    want = STEPS * attention_calls(demo_spec.n_src, demo_spec.n_tgt, cfg.denoising_layer_types)
    n_kp, n_at = kpconv_cuda_bf16.launches, masked_attention_cuda_bf16.launches
    f32 = kpconv_cuda.launches + masked_attention_cuda.launches
    if n_kp != 11 or n_at != want or f32 or not all(
            math.isfinite(summary[k]) for k in ("IR", "FMR", "RR")):
        raise AssertionError(f"main 3dmatch_fast.yaml: {n_kp} bf16 KPConv, {n_at} bf16 "
                             f"attention, {f32} f32 launches; summary {summary}")
    launches["kpconv_bf16"] += n_kp
    launches["masked_attention_bf16"] += n_at
    log(f"main 3DMatch fast (configs/test/3dmatch_fast.yaml, demo), {BATCH_PAIRS} pairs: "
        f"{seconds:.2f} s, launches bf16 kpconv {n_kp} attention {n_at}, f32 0; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in summary.items()))
    at["ddim_profile"] = profiles
    return [kp, at], pairs_per_s


def run_bf16_training(repo, batch, one, batch4_cpu, f32_train, launches):
    """Phase 8c, bf16 training (compute_dtype bfloat16 and precision default
    with mode train, as tools/bench_train.py trains the JAX package): the
    3DMatch Trainer at full width (gate 200, SGD) for a warm-up and five timed
    steps with resume, beside phase 7's f32 numbers; one step of pair 0 card
    against CPU (and against the card's f32 step); the 4DMatch Trainer at
    preset_4dmatch's widths (instance 144); ``main --mode train`` on copies of
    configs/train/3dmatch.yaml and 4dmatch.yaml with the two keys, then
    ``--mode test`` with configs/test/3dmatch_fast.yaml on the 3DMatch
    checkpoint. Returns the numbers for the kernels' JSON line."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.models.presets import preset_3dmatch, preset_4dmatch, with_fast_path
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16
    from diffreg_tpu_torch.utils.config import load_yaml

    cfg_train = preset_3dmatch(train=True)
    bf16 = run_training(with_fast_path(cfg_train), batch, launches, bf16=True)
    log(f"train 3DMatch, bf16 against f32 (same call): {bf16['steps_per_s']:.3f} against "
        f"{f32_train['steps_per_s']:.3f} steps/s; forward {bf16['forward_s']:.4f} / "
        f"{f32_train['forward_s']:.4f} s, backward {bf16['backward_s']:.4f} / "
        f"{f32_train['backward_s']:.4f} s, optimizer {bf16['optimizer_s']:.4f} / "
        f"{f32_train['optimizer_s']:.4f} s; peak {bf16['peak_gib']:.2f} / "
        f"{f32_train['peak_gib']:.2f} GiB")
    pair0 = train_step_card_vs_cpu(with_fast_path(cfg_train), one, TRAIN_BF16_LIMITS,
                                   f32_cfg=cfg_train, tag=" bf16")
    cfg4 = with_fast_path(preset_4dmatch(sample_steps=STEPS))
    train4 = run_training(cfg4, batch4_cpu.to("cuda"), launches, bf16=True,
                          loss_cfg=LossConfig(**LOSS_4D),
                          tag="4DMatch", steps=TRAIN_STEPS_4D,
                          attention_key="masked_attention_bf16_d144")

    configs = os.path.join(repo, "configs")
    keys = {"compute_dtype": "bfloat16", "precision": "default"}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in ("3dmatch", "4dmatch"):
            raw = load_yaml(os.path.join(configs, "train", f"{name}.yaml"))
            raw.update(keys, max_epoch=1, exp_dir=f"train-{name}-bf16")
            paths[name] = os.path.join(tmp, f"train_{name}_bf16.yaml")
            with open(paths[name], "w") as f:
                yaml.safe_dump(raw, f)
        ckpt = os.path.join(tmp, "snapshot", "train-3dmatch-bf16", "checkpoints")
        raw = load_yaml(os.path.join(configs, "test", "3dmatch_fast.yaml"))
        raw.update(pretrain=ckpt, exp_dir="test-3dmatch-fast-trained")
        paths["test"] = os.path.join(tmp, "test_3dmatch_fast.yaml")
        with open(paths["test"], "w") as f:
            yaml.safe_dump(raw, f)
        fast = with_fast_path(preset_3dmatch())
        layers = tuple(fast.coarse_transformer.layer_types) + tuple(fast.denoising_layer_types)
        specs = {name: synthetic_batch(batch_size=1, n_points=768, seed=0,
                                       deformable=name == "4dmatch")[1]
                 for name in ("3dmatch", "4dmatch")}
        # (name, config, arguments, pairs per batch, summary keys, attention
        # launches per batch, launches key)
        runs = [(f"{name} train bf16 (demo)", paths[name], ["--demo", "--mode", "train"], 2,
                 ("loss",), attention_calls(specs[name].n_src, specs[name].n_tgt, layers),
                 "masked_attention_bf16_d144" if name == "4dmatch" else "masked_attention_bf16")
                for name in ("3dmatch", "4dmatch")]
        runs.append(("3DMatch test on the bf16-trained checkpoint (3dmatch_fast.yaml, demo)",
                     paths["test"], ["--demo"], BATCH_PAIRS, ("IR", "FMR", "RR"),
                     STEPS * attention_calls(specs["3dmatch"].n_src, specs["3dmatch"].n_tgt,
                                             fast.denoising_layer_types),
                     "masked_attention_bf16"))
        os.chdir(tmp)
        try:
            for name, config, extra, batch_size, summary_keys, attn, key in runs:
                for fn in (kpconv_cuda, masked_attention_cuda, kpconv_cuda_bf16,
                           masked_attention_cuda_bf16):
                    fn.launches = 0
                argv = ["--config", config, "--num-pairs", str(BATCH_PAIRS), "--batch-size",
                        str(batch_size), *extra]
                summary, seconds = wall(lambda: cli(argv))
                batches = BATCH_PAIRS // batch_size
                n_kp, n_at = kpconv_cuda_bf16.launches, masked_attention_cuda_bf16.launches
                f32 = kpconv_cuda.launches + masked_attention_cuda.launches
                if n_kp != 11 * batches or n_at != attn * batches or f32:
                    raise AssertionError(f"main {name}: {n_kp} bf16 KPConv, {n_at} bf16 "
                                         f"attention, {f32} f32 launches")
                if not all(math.isfinite(summary[k]) for k in summary_keys):
                    raise AssertionError(f"main {name}: summary {summary}")
                launches["kpconv_bf16"] += n_kp
                launches[key] += n_at
                log(f"main {name}, {BATCH_PAIRS} pairs: {seconds:.2f} s, launches bf16 kpconv "
                    f"{n_kp} attention {n_at}, f32 0; " + ", ".join(
                        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in summary.items()))
            for name in ("3dmatch", "4dmatch"):
                if not os.path.isfile(os.path.join(tmp, "snapshot", f"train-{name}-bf16",
                                                   "checkpoints", "1.pt")):
                    raise AssertionError(f"main {name} train bf16: no checkpoint")
            with open(os.path.join(tmp, "snapshot", "test-3dmatch-fast-trained", "log.txt")) as f:
                if f"restored weights from {ckpt}" not in f.read():
                    raise AssertionError("main 3dmatch_fast.yaml: the bf16-trained checkpoint "
                                         "was not restored")
        finally:
            os.chdir(cwd)
    return {"train_3dmatch": {"bf16": bf16, "f32": f32_train}, "train_4dmatch": train4,
            "pair0": pair0}


# ---------------------------------------------------------------- 2D-3D


def _png_chunk(kind, body):
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, img):
    """An 8-bit RGB [H, W, 3] or 16-bit gray [H, W] PNG whose rows cycle
    through the five filter types (the port's reader must undo each)."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    nbytes = img.dtype.itemsize
    rows = (img.astype(">u2").view(np.uint8) if nbytes == 2 else img).reshape(h, -1)
    rows = rows.astype(np.int32)
    bpp = ch * nbytes
    raw, prev = [], np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        ftype, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, 8 * nbytes, 0 if ch == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(b"".join(raw), 6)) + _png_chunk(b"IEND", b""))


def write_2d3d_split(root, subset="test", seed=7):
    """BATCH_PAIRS RGB-D Scenes V2-like pairs as the reader's on-disk layout:
    data/<scene>/{camera-intrinsics.txt, depth, image, cloud} and
    metadata/<subset>.pkl (the test subset's scenes are scene_00 and scene_01,
    another subset's <subset>_00 and <subset>_01).
    A pair: a smooth scene's 16-bit depth (mm) and 8-bit RGB texture on a
    480 x 640 Kinect sensor (f = 570.3, principal point at the centre), and a
    cloud of CLOUD_POINTS points of the same surface, sampled at continuous
    pixel positions over columns 0.3 W .. 1.4 W (so it partly overlaps the
    view), in a world frame under a known camera-from-cloud pose."""
    import pickle

    import numpy as np
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(seed)
    h, w = SENSOR_HW
    k = np.array([[KINECT_F, 0, (w - 1) / 2], [0, KINECT_F, (h - 1) / 2], [0, 0, 1]])
    meta = []
    for i in range(BATCH_PAIRS):
        scene = f"{'scene' if subset == 'test' else subset}_{i // 2:02d}"
        a = rs.rand(6)

        def depth_at(u, v):
            return (1.8 + 0.4 * a[0] + 0.3 * np.sin(u / 70.0 + 6 * a[1])
                    + 0.2 * np.cos(v / 55.0 + 6 * a[2]) + 4e-4 * (u - w / 2) * (a[3] - 0.5))

        vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
        depth_mm = np.round(depth_at(uu, vv) * 1000).astype(np.uint16)
        depth_mm[: 12 + int(20 * a[4]), : 40] = 0                # a hole without depth
        tex = 0.5 + 0.25 * np.sin(uu / 9.0 + 6 * a[5]) * np.cos(vv / 13.0) \
            + 0.1 * rs.rand(h, w)
        rgb = np.clip(np.stack([tex, tex ** 1.2, 1.0 - 0.5 * tex], -1) * 255, 0, 255)
        u = rs.uniform(0.3 * w, 1.4 * w, CLOUD_POINTS)
        v = rs.uniform(0, h, CLOUD_POINTS)
        z = depth_at(u, v)
        cam = np.stack([(u - k[0, 2]) * z / KINECT_F, (v - k[1, 2]) * z / KINECT_F, z], -1)
        rot = Rotation.from_euler("zyx", rs.uniform(-np.pi, np.pi, 3)).as_matrix()
        trn = rs.randn(3) * 0.5
        tfm = np.eye(4)
        tfm[:3, :3], tfm[:3, 3] = rot, trn
        world = ((cam - trn) @ rot).astype(np.float32)
        d = os.path.join(root, "data", scene)
        for sub in ("depth", "image", "cloud"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        np.savetxt(os.path.join(d, "camera-intrinsics.txt"), k)
        write_png(os.path.join(d, "depth", f"{i:06d}.png"), depth_mm)
        write_png(os.path.join(d, "image", f"{i:06d}.png"), rgb.astype(np.uint8))
        np.save(os.path.join(d, "cloud", f"{i:06d}.npy"), world)
        meta.append({"scene_name": scene, "depth_file": f"{scene}/depth/{i:06d}.png",
                     "image_file": f"{scene}/image/{i:06d}.png",
                     "cloud_file": f"{scene}/cloud/{i:06d}.npy", "overlap": 0.5,
                     "cloud_to_image": tfm.astype(np.float32)})
    os.makedirs(os.path.join(root, "metadata"), exist_ok=True)
    with open(os.path.join(root, "metadata", f"{subset}.pkl"), "wb") as f:
        pickle.dump(meta, f)


def data_2d3d(root, subset="test", augment=False, stride=8, towers=None):
    """A subset of the split read back through the port's reader (with the
    training augmentation when ``augment``), calibrated and cropped to the
    coarse ``stride`` as main.py does, with each pair's tower outputs from the
    TowerRunner ``towers`` when given: (batch of CPU tensors, spec, scene
    names, pixels a pair)."""
    import numpy as np

    from diffreg_tpu_torch.data.calibrate import calibrate_spec_2d3d
    from diffreg_tpu_torch.data.collate2d3d import batch_2d3d, build_2d3d_sample
    from diffreg_tpu_torch.data.datasets2d3d import RGBDScenes2D3DPairDataset

    ds = RGBDScenes2D3DPairDataset(root, subset, use_augmentation=augment)
    raws = [ds[i] for i in range(len(ds))]
    spec = calibrate_spec_2d3d([r["points"] for r in raws])
    samples = []
    for r in raws:
        h, w = (n // stride * stride for n in r["depth"].shape)
        for key in ("depth", "image", "image_gray"):
            r[key] = r[key][:h, :w]
        samples.append(build_2d3d_sample(r, spec, stride))
        if towers is not None:
            samples[-1]["dino_feats"] = towers.dino_tokens(r["image"][None])[0]
            samples[-1]["mono_depth"] = towers.mono_depth(r["image"][None])[0]
    batch = batch_2d3d(samples)
    return batch, spec, [r["scene_name"] for r in raws], int(np.prod(batch.image.shape[1:3]))


def attention_cases_2d3d(batch, n_tokens):
    """The fusion's attention calls of one pass, as (name, query length, key
    mask, calls): image self (no mask), node self (the nodes' padding), image
    -> node, node -> image, three of each."""
    import torch

    b = batch.batch_size
    nodes = batch.masks[-1].cuda()
    img = torch.ones(b, n_tokens, dtype=torch.bool, device="cuda")
    n = nodes.shape[1]
    return [("image_self", n_tokens, img, 3), ("node_self", n, nodes, 3),
            ("image_to_node", n_tokens, nodes, 3), ("node_to_image", n, img, 3)]


def check_attention_2d3d(batch, n_tokens, cfg, gen, tag=" (2D-3D)"):
    """Kernel vs plain attention at the fusion's shapes (head width
    ``cfg.hidden_dim / cfg.num_heads``), and a node count that is not a
    multiple of 32 (pair 0's real nodes); SDPA as the yardstick. Returns the
    JSON entry (totals per fusion pass) and the cases."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_plain

    h = cfg.num_heads
    d = cfg.hidden_dim // h
    scale = d ** -0.5
    cases = attention_cases_2d3d(batch, n_tokens)
    real = int(batch.masks[-1][0].sum())
    real -= 1 if real % 32 == 0 else 0
    tail = [("node_self_tail", real, batch.masks[-1][:1, :real].cuda().contiguous(), 0)]
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bytes", "mma_flops", "flops")}
    worst, per_shape = 0.0, []
    with torch.inference_mode():
        for name, length, kv_mask, calls in cases + tail:
            bb, keys = kv_mask.shape
            q = torch.randn(bb, h, length, d, generator=gen).cuda()
            k, v = (torch.randn(bb, h, keys, d, generator=gen).cuda() for _ in range(2))
            kv_mask = kv_mask.contiguous()
            before = masked_attention_cuda.launches
            got = masked_attention_cuda(q, k, v, kv_mask, scale)
            ref = masked_attention_plain(q, k, v, kv_mask, scale)
            torch.cuda.synchronize()
            assert masked_attention_cuda.launches == before + 1
            err = float((got - ref).abs().max())
            if not math.isfinite(err) or err > ATTENTION_ABS_TOL:
                raise AssertionError(f"attention {name}{tag}: max abs err {err}")
            worst = max(worst, err)
            lib_mask = kv_mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=scale)
            lib_err = float((lib - ref).abs().max())
            ms = time_cuda(lambda: masked_attention_cuda(q, k, v, kv_mask, scale), 20)
            plain = time_cuda(lambda: masked_attention_plain(q, k, v, kv_mask, scale), 5,
                              warmup=1)
            lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=scale), 20)
            nbytes, mma_flops, flops = attention_work(q, k, kv_mask)
            bms, by = bound_ms(nbytes, mma_flops, flops)
            per_shape.append({"case": name + tag, "b": bb, "h": h, "l": length, "s": keys,
                              "d": d, "calls": calls, "ms": ms, "plain_ms": plain,
                              "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                              "max_abs_err": err, "library_max_abs_err": lib_err})
            log(f"attention {name}{tag} [{bb},{h},{length}x{keys},{d}] x{calls}: err "
                f"{err:.3e} (limit {ATTENTION_ABS_TOL:.1e}) kernel {ms:.4f} ms plain "
                f"{plain:.4f} ms sdpa {lib_ms:.4f} ms (err {lib_err:.3e}) bound {bms:.4f} ms "
                f"({by})")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                             ("bytes", nbytes), ("mma_flops", mma_flops), ("flops", flops)):
                totals[key] += calls * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"])
    entry = {"max_abs_err": worst, "ms": totals["ms"], "plain_ms": totals["plain_ms"],
             "bound_ms": bms, "bound_by": by, "library_ms": totals["library_ms"],
             "per": "one fusion pass (12 calls)"}
    return entry, per_shape, cases


def attention_gradients_2d3d(cases, cfg, gen, tag=" (2D-3D)"):
    """MaskedAttentionFunction against plain autograd at each of the fusion's
    four shapes; returns (worst relative error, backward ms per call by case,
    backward ms per fusion pass)."""
    import torch

    from diffreg_tpu_torch.ops.attention import (MaskedAttentionFunction, masked_attention_cuda,
                                                 masked_attention_plain)

    h = cfg.num_heads
    d = cfg.hidden_dim // h
    scale = d ** -0.5
    worst, per_call, per_pass = 0.0, {}, 0.0
    for name, length, kv_mask, calls in cases:
        bb, keys = kv_mask.shape
        qkv = [torch.randn(bb, h, n, d, generator=gen).cuda() for n in (length, keys, keys)]
        err, ms = grad_case(f"attention {name}{tag} [{bb},{h},{length}x{keys},{d}]",
                            lambda *a: MaskedAttentionFunction.apply(*a, scale),
                            (*qkv, kv_mask.contiguous()), (0, 1, 2),
                            lambda *a: masked_attention_plain(*a, scale), gen, calls,
                            masked_attention_cuda)
        del qkv
        torch.cuda.empty_cache()
        worst, per_call[name] = max(worst, err), ms
        per_pass += calls * ms
    return worst, per_call, per_pass


def fixed_draws_tester(model, cfg, device, x_init, u):
    """A TwoDThreeDTester whose draws are the given tensors (pair 0 on the card
    and on the CPU from the same start and PnP draws)."""
    from diffreg_tpu_torch.engine.tester2d3d import TwoDThreeDTester

    t = TwoDThreeDTester(model, cfg, device=device)
    t.draw_start = lambda batch, n, m, generator: x_init.to(device)
    t.draw_pnp = lambda batch, generator: u.to(device)
    return t


def check_pnp_2d3d(batch_cpu, u, gen):
    """PnP-RANSAC on the card and on the CPU against pair 0's ground-truth pose:
    2048 of its cloud points in front of the camera, projected under the pose,
    40% of the pixels moved 20 to 100 px, so that none is an inlier at the
    8 px tolerance. (A random pixel can land within 8 px of its point's
    projection; a pose that counts it beats the exact one by one inlier, and
    RANSAC rightly keeps that pose.)"""
    import torch

    from diffreg_tpu_torch.eval.pnp import pnp_ransac

    pts = batch_cpu.points[0][0][batch_cpu.masks[0][0]]
    tfm, k = batch_cpu.transform[0], batch_cpu.intrinsics[0]
    cam = pts @ tfm[:3, :3].T + tfm[:3, 3]
    keep = torch.nonzero(cam[:, 2] > 0.2)[:, 0]
    sel = keep[torch.randperm(len(keep), generator=gen)[:2048]]
    pts, cam = pts[sel], cam[sel]
    pix = torch.stack([cam[:, 0] / cam[:, 2] * k[0, 0] + k[0, 2],
                       cam[:, 1] / cam[:, 2] * k[1, 1] + k[1, 2]], -1)
    bad = torch.rand(len(pix), generator=gen) < 0.4
    angle = torch.rand(int(bad.sum()), generator=gen) * 2 * math.pi
    radius = 20.0 + 80.0 * torch.rand(int(bad.sum()), generator=gen)
    pix[bad] += torch.stack([torch.cos(angle), torch.sin(angle)], -1) * radius[:, None]
    valid = torch.ones(len(pts), dtype=torch.bool)
    for name, dev in (("card", "cuda"), ("CPU", "cpu")):
        res = pnp_ransac(u.to(dev), pts.to(dev), pix.to(dev), valid.to(dev), k.to(dev))
        err = max(float((res.rotation.cpu() - tfm[:3, :3]).abs().max()),
                  float((res.translation.cpu()[:, 0] - tfm[:3, 3]).abs().max()))
        log(f"PnP on the {name}: {int(res.inlier_count)} inliers of {len(pts)} "
            f"({int((~bad).sum())} true), pose error {err:.3e} (limit {PNP_POSE_TOL:.0e})")
        if not (bool(res.success) and err <= PNP_POSE_TOL):
            raise AssertionError(f"PnP on the {name} missed the ground-truth pose by {err}")


def mask_agreement(got, ref):
    """Pair 0's top-1 union masks, card (``got``) against CPU (``ref``): the
    confidences' largest difference on valid entries, the entries that differ
    (and the cap, 1% of the CPU mask's entries plus 2), those outside a
    near-tie (a row's or column's best two CPU confidences within twice the
    confidence limit), and the share of real node rows free of a near-tie."""
    import torch

    valid = ref["node_masks"][:, :, None] & ref["img_valid_c"][:, None, :]
    conf = ref["conf_matrix_pred"]
    conf_err = float((got["conf_matrix_pred"].cpu() - conf).abs()[valid].max())
    differ = (got["corr_mask"].cpu() != ref["corr_mask"]) & valid
    c = torch.where(valid, conf, torch.full_like(conf, -1.0))
    top_r, top_c = c.topk(2, dim=2).values, c.topk(2, dim=1).values
    row_tie = (top_r[..., 0] - top_r[..., 1]) <= 2 * CONF_2D3D_ABS_TOL        # [1, N]
    col_tie = (top_c[:, 0] - top_c[:, 1]) <= 2 * CONF_2D3D_ABS_TOL            # [1, M]
    real = ref["node_masks"][0]
    out = {"conf_err": conf_err, "differ": int(differ.sum()),
           "cap": MASK_DIFFER_SHARE * max(int(ref["corr_mask"].sum()), 1) + 2,
           "unexplained": int((differ & ~(row_tie[:, :, None] | col_tie[:, None, :])).sum()),
           "tie_free": float((~row_tie[0] & real).sum()) / max(int(real.sum()), 1)}
    out["text"] = (f"conf {conf_err:.3e} (limit {CONF_2D3D_ABS_TOL:.0e}, max conf "
                   f"{float(conf.max()):.3e}), {out['differ']} of {int(valid.sum())} valid mask "
                   f"entries differ (cap {out['cap']:.0f}), {out['unexplained']} outside a "
                   f"near-tie (limit 0), real node rows free of a near-tie {out['tie_free']:.4f} "
                   f"of {int(real.sum())} (limit {TIE_FREE_ROWS_MIN}), masks "
                   f"{int(got['corr_mask'].sum())} vs {int(ref['corr_mask'].sum())}")
    return out


def pair0_2d3d(cfg, tcfg, batch_cpu, x_init, u, launches, key, tag):
    """Pair 0 on the card and on the CPU (plain versions) at STEPS_2D3D_CPU DDIM
    steps with the same weights and draws, the matchers sharpened: the DDIM's
    and the coarse matcher's confidences and top-1 masks (mask_agreement's
    limits), and the fine matches on the card's coarse correspondences. The
    card's attention launches count under ``launches[key]``."""
    import torch

    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    cfg_short = dataclasses.replace(cfg, sample_steps=STEPS_2D3D_CPU)
    one = batch_cpu.select(slice(0, 1))
    res = {}
    for dev in ("cuda", "cpu"):
        m2 = DiffReg2D3D(cfg_short, device=dev, seed=0)
        with torch.no_grad():
            for matcher in (m2.coarse_matching, m2.denoising_coarse_matching):
                matcher.src_proj.weight.mul_(SHARPEN_2D3D)
        t = fixed_draws_tester(m2, tcfg, dev, x_init[:1], u[:1])
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            res[dev] = t.forward(one.to(dev), None)
            res[dev + "_backbone"] = m2(one.to(dev), mode="backbone")
        res[dev + "_s"] = time.perf_counter() - t0
        if dev == "cuda":
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 16 or n_at != 12 * (2 + STEPS_2D3D_CPU):
                raise AssertionError(f"{tag} pair 0: {n_kp} KPConv, {n_at} attention launches")
            launches["kpconv"] += n_kp
            launches["kpconv_2d3d"] += n_kp
            launches[key] += n_at
    (got, got_corrs, got_pairs), (ref, _, ref_pairs) = res["cuda"], res["cpu"]
    ddim = mask_agreement(got, ref)
    coarse = mask_agreement(res["cuda_backbone"], res["cpu_backbone"])

    # the CPU's fine matching of its own features on the card's coarse correspondences
    n_got, n_ref, fine_agree = fine_agreement(got_corrs, got_pairs, ref, one, tcfg,
                                              cfg.coarse_stride)
    log(f"{tag} card vs CPU, pair 0 ({STEPS_2D3D_CPU} steps, matchers sharpened x{SHARPEN_2D3D}, "
        f"CPU {res['cpu_s']:.1f} s, card {res['cuda_s']:.2f} s): DDIM {ddim['text']}; coarse "
        f"matcher (backbone mode) {coarse['text']}; fine correspondences on the card's coarse "
        f"ones {n_got} vs {n_ref}, shared {fine_agree:.4f} of the union (limit "
        f"{FINE_2D3D_AGREEMENT}); the CPU's own run {int(ref_pairs[0]['n_corr'])}; IR "
        f"{float(got_pairs[0]['IR']):.4f} vs {float(ref_pairs[0]['IR']):.4f}")
    for name, agree in (("DDIM", ddim), ("coarse matcher", coarse)):
        if not agree["conf_err"] <= CONF_2D3D_ABS_TOL:
            raise AssertionError(f"{tag} {name}: confidences differ from the CPU's by "
                                 f"{agree['conf_err']}")
        if agree["unexplained"]:
            raise AssertionError(f"{tag} {name}: {agree['unexplained']} corr_mask entries differ "
                                 "outside near-ties")
    # the cap and the tie-free share hold the coarse matcher's mask, not the
    # DDIM's: with random weights the DDIM's rows are all near-ties (phase 19
    # holds the DDIM output on the 2D-3D story's trained weights)
    if not (coarse["differ"] <= coarse["cap"] and coarse["tie_free"] >= TIE_FREE_ROWS_MIN):
        raise AssertionError(f"{tag} coarse matcher: {coarse['text']}")
    if not (n_ref > 0 and fine_agree >= FINE_2D3D_AGREEMENT):
        raise AssertionError(f"{tag}: fine correspondences share {fine_agree} of the union")


def run_2d3d(batch_cpu, scenes, cfg, launches, gen, key="masked_attention_d64", tag="2D-3D",
             config="configs/test/rgbdv2.yaml"):
    """The 2D-3D path at full width through TwoDThreeDTester (one warm-up, three
    timed runs, launches asserted), where its time goes, pair 0 on the CPU
    against the card at STEPS_2D3D_CPU steps, and PnP on a known pose. The
    attention launches count under ``launches[key]``."""
    import torch

    from diffreg_tpu_torch.engine.tester2d3d import Test2D3DConfig, TwoDThreeDTester
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.ops.partition import point_to_node_partition

    per_forward = 12 * (1 + cfg.sample_steps)
    tcfg = Test2D3DConfig(fine_threshold=FINE_THR_2D3D)
    model = DiffReg2D3D(cfg, device="cuda", seed=0)
    tester = TwoDThreeDTester(model, tcfg, device="cuda")
    batch = batch_cpu.to("cuda")
    make_iter = lambda: iter([(batch, scenes)])  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        tester.test(make_iter, torch.Generator("cuda").manual_seed(0))           # warm-up
        times = []
        for run in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            kpconv_cuda.route_launches = {}
            masked_attention_cuda.launches = 0
            summary, seconds = wall(lambda: tester.test(
                make_iter, torch.Generator("cuda").manual_seed(1 + run)))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            routes = dict(kpconv_cuda.route_launches)
            if n_kp != 8 or n_at != per_forward or routes != BACKBONE_2D3D_ROUTES:
                raise AssertionError(f"{tag} tester: {n_kp} KPConv launches (want 8) by route "
                                     f"{routes} (want {BACKBONE_2D3D_ROUTES}), {n_at} "
                                     f"attention launches (want {per_forward})")
            launches["kpconv"] += n_kp
            launches["kpconv_2d3d"] += n_kp
            launches["kpconv_any_shape"] += routes["any_shape_tensor_cores"]
            launches[key] += n_at
            times.append(seconds)
            if not (summary["pairs"] == BATCH_PAIRS and summary["n_corr"] > 0
                    and all(math.isfinite(summary[k]) for k in ("IR", "PIR", "RR", "RRE",
                                                                  "RTE"))):
                raise AssertionError(f"{tag} tester summary {summary}")
        seconds = sorted(times)[TIMED_RUNS // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = batch.points[-1].shape[1]
        s = cfg.coarse_stride
        m = (batch.image.shape[1] // s) * (batch.image.shape[2] // s)
        x_init = torch.randn(BATCH_PAIRS, n, m, generator=gen)
        u = torch.rand(BATCH_PAIRS, PNP_HYPOTHESES, 6, generator=gen)
        fixed = fixed_draws_tester(model, tcfg, "cuda", x_init, u)
        _, enc_s = wall(lambda: model.encode(batch))
        _, part_s = wall(lambda: point_to_node_partition(
            batch.points[0], batch.points[-1], batch.masks[0], batch.masks[-1],
            cfg.pcd_num_points_in_patch))
        _, bb_s = wall(lambda: model(batch, mode="backbone"))
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        _, ddim_s = wall(lambda: model(batch, mode="ddim", x_init=x_init.cuda()))
        (out, corrs, pairs), fwd_s = wall(lambda: fixed.forward(batch, None))
        n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
        if n_kp != 16 or n_at != 2 * per_forward:
            raise AssertionError(f"{tag} forwards: {n_kp} KPConv, {n_at} attention launches")
        launches["kpconv"] += n_kp
        launches["kpconv_2d3d"] += n_kp
        launches[key] += n_at
    coarse = [int(c) for c in out["corr_mask"].sum(dim=(1, 2))]
    fine = [int(p["n_corr"]) for p in pairs]
    log(f"{tag} path (TwoDThreeDTester, {config} widths, SAMPLE_STEP "
        f"{cfg.sample_steps}, fine threshold {FINE_THR_2D3D}): {BATCH_PAIRS} pairs in "
        f"{seconds:.4f} s (median of {', '.join(f'{t:.4f}' for t in times)}) = "
        f"{BATCH_PAIRS / seconds:.3f} pairs/s; IR {summary['IR']:.4f} PIR {summary['PIR']:.4f} "
        f"RR {summary['RR']:.4f} RRE {summary['RRE']:.3f} RTE {summary['RTE']:.4f}; coarse "
        f"correspondences {coarse}, fine {fine}; launches kpconv {n_kp // 2} attention "
        f"{n_at // 2} a forward; peak memory {peak:.2f} GiB")
    log(f"{tag} where the time goes ({BATCH_PAIRS} pairs): encode {enc_s:.4f} s, partition "
        f"{part_s:.4f} s, backbone mode (encode, partition, one fusion pass, matcher) "
        f"{bb_s:.4f} s, ddim forward {ddim_s:.4f} s (so {cfg.sample_steps} DDIM steps "
        f"{ddim_s - bb_s:.4f} s = {(ddim_s - bb_s) / cfg.sample_steps * 1e3:.2f} ms a step), "
        f"fine matching + PnP {fwd_s - ddim_s:.4f} s")

    # ---- pair 0 on the CPU, same weights and draws, at STEPS_2D3D_CPU ----
    pair0_2d3d(cfg, tcfg, batch_cpu, x_init, u, launches, key, tag)
    check_pnp_2d3d(batch_cpu, u[0], gen)
    return {"pairs_per_s": BATCH_PAIRS / seconds, "peak_gib": peak,
            "ms_per_ddim_step": (ddim_s - bb_s) / cfg.sample_steps * 1e3, "encode_s": enc_s,
            "backbone_s": bb_s, "ddim_s": ddim_s, "fine_and_pnp_s": fwd_s - ddim_s}


def run_cli_2d3d(repo, split_root, launches):
    """``diffreg_tpu_torch.main`` on the 2D-3D configs in a temporary working
    directory: rgbdv2.yaml and 7scenes.yaml with --demo, and rgbdv2.yaml on the
    split under ``split_root`` with a checkpoint of random weights (main's own
    calibration, the PNG reader, the restore, the npz cache, eval_from_cache)."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import load_yaml

    configs = os.path.join(repo, "configs", "test")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        disk = load_yaml(os.path.join(configs, "rgbdv2.yaml"))
        disk.update(data_root=split_root, exp_dir="disk-rgbdv2", pretrain=os.path.join(tmp, "ckpt"))
        CheckpointManager(disk["pretrain"]).save(1, create_train_state(
            DiffReg2D3D(pipeline_2d3d_config(disk), device="cpu", seed=0), OptimConfig()))
        with open(os.path.join(tmp, "disk_rgbdv2.yaml"), "w") as f:
            yaml.safe_dump(disk, f)
        # (name, config, extra arguments, DDIM steps)
        runs = [("rgbdv2 test (demo)", os.path.join(configs, "rgbdv2.yaml"), ["--demo"], 50),
                ("7scenes test (demo)", os.path.join(configs, "7scenes.yaml"), ["--demo"], 10),
                ("rgbdv2 test (on disk)", os.path.join(tmp, "disk_rgbdv2.yaml"), [], 50)]
        os.chdir(tmp)
        try:
            for name, config, extra, steps in runs:
                kpconv_cuda.launches = 0
                masked_attention_cuda.launches = 0
                argv = ["--config", config, "--num-pairs", str(BATCH_PAIRS),
                        "--batch-size", str(BATCH_PAIRS), *extra]
                summary, seconds = wall(lambda: cli(argv))
                n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
                if n_kp != 8 or n_at != 12 * (1 + steps):
                    raise AssertionError(f"main {name}: {n_kp} KPConv, {n_at} attention launches")
                if not (summary["pairs"] == BATCH_PAIRS and all(
                        math.isfinite(summary[k]) for k in ("IR", "PIR", "RR", "RRE", "RTE"))):
                    raise AssertionError(f"main {name}: summary {summary}")
                if "disk" in name:
                    ev = summary.get("eval", {})
                    if sorted(ev.get("scenes", {})) != ["scene_00", "scene_01"] \
                            or not math.isfinite(ev.get("PIR", math.nan)):
                        raise AssertionError(f"main {name}: eval_from_cache gave {ev}")
                launches["kpconv"] += n_kp
                launches["kpconv_2d3d"] += n_kp
                launches["masked_attention_d64"] += n_at
                log(f"main {name}, {BATCH_PAIRS} pairs: {seconds:.2f} s, launches kpconv {n_kp} "
                    f"attention {n_at}; " + ", ".join(
                        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in summary.items() if k != "eval"))
        finally:
            os.chdir(cwd)


def counted_train_step_2d3d(step, rows, launches):
    """``step`` with its launches counted and asserted (8 KPConv, 24
    attention), its loss terms and gradients' finiteness checked, and its
    forward / backward / optimizer seconds recorded in ``rows``."""
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.logging import Timers

    def counted(state, batch, inputs, timers=None):
        phases = Timers()
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        state, info = step(state, batch, inputs, phases)
        n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
        if n_kp != 8 or n_at != TRAIN_ATTENTION_2D3D:
            raise AssertionError(f"2D-3D train step: {n_kp} KPConv launches (want 8), {n_at} "
                                 f"attention launches (want {TRAIN_ATTENTION_2D3D})")
        terms = {k: float(info[k]) for k in LOSS_TERMS_2D3D}
        if not (all(math.isfinite(v) for v in terms.values()) and bool(info["grads_finite"])):
            raise AssertionError(f"2D-3D train step: {terms}, grads finite "
                                 f"{bool(info['grads_finite'])}")
        launches["kpconv_train_2d3d"] += n_kp
        launches["masked_attention_train_2d3d"] += n_at
        rows.append({**terms, "grad_norm": float(info["grad_norm"]), **phases.summary()})
        return state, info
    return counted


def train_2d3d_trainer(cfg, batch_cpu, circle_cfg, fine_cfg, launches,
                       tag="2D-3D train (configs/train/rgbdv2.yaml widths"):
    """The Trainer at configs/train/rgbdv2.yaml widths (batch 1, Adam at lr
    1e-4; ``cfg`` another 2D-3D model, ``tag`` names it): one epoch of a
    warm-up and TIMED_STEPS_2D3D timed steps over the train split's pairs,
    then ``resume`` from its checkpoint."""
    import tempfile

    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig
    from diffreg_tpu_torch.engine.train2d3d import create_train_state_2d3d, make_train_step_2d3d
    from diffreg_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D

    optim = OptimConfig(optimizer="adam", lr=1e-4)
    step = make_train_step_2d3d(circle_cfg, LossConfig(), fine_cfg)
    rows = []
    steps = 1 + TIMED_STEPS_2D3D
    pairs = [batch_cpu.select(slice(i % BATCH_PAIRS, i % BATCH_PAIRS + 1)) for i in range(steps)]
    state = create_train_state_2d3d(DiffReg2D3D(cfg, device="cuda", seed=0), optim)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(counted_train_step_2d3d(step, rows, launches), state,
                          lambda epoch: ((p, None) for p in pairs),
                          TrainerConfig(max_epoch=1, log_every=steps, save_dir=tmp), seed=0)
        t0 = time.perf_counter()
        state = trainer.train()
        epoch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        fresh = create_train_state_2d3d(DiffReg2D3D(cfg, device="cuda", seed=1), optim)
        resumed = Trainer(step, fresh, lambda epoch: iter(()),
                          TrainerConfig(max_epoch=1, save_dir=tmp), seed=0)
        resumed.resume()
    same = all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                 resumed.state.model.parameters()))
    if not (same and resumed.start_epoch == 1 and resumed.state.step == steps
            and resumed.state.optimizer.count == steps):
        raise AssertionError(f"2D-3D resume: params equal {same}, epoch {resumed.start_epoch}, "
                             f"step {resumed.state.step}, updates {resumed.state.optimizer.count}")
    timed = rows[1:]
    med = lambda key: sorted(r[key] for r in timed)[len(timed) // 2]  # noqa: E731
    step_s = med("forward") + med("backward") + med("optimizer")
    log(f"{tag}, 1 pair a step, Adam lr {optim.lr}): "
        f"{steps} steps in {epoch_s:.3f} s (epoch with checkpoint); per timed step median "
        f"forward {med('forward'):.4f} s, backward {med('backward'):.4f} s, optimizer "
        f"{med('optimizer'):.4f} s = {step_s:.4f} s: {1 / step_s:.3f} steps/s (backward "
        f"{med('backward') / step_s:.3f} of the step); peak memory {peak:.2f} GiB; launches a "
        f"step kpconv 8 attention {TRAIN_ATTENTION_2D3D}; resume ok")
    log("2D-3D train losses " + "; ".join(
        ", ".join(f"{k} {r[k]:.5f}" for k in LOSS_TERMS_2D3D) for r in rows))
    log("2D-3D train step seconds (forward, backward, optimizer) " + "; ".join(
        f"{r['forward']:.4f} {r['backward']:.4f} {r['optimizer']:.4f}" for r in rows))
    return {"steps_per_s": 1 / step_s, "forward_s": med("forward"),
            "backward_s": med("backward"), "optimizer_s": med("optimizer"), "peak_gib": peak}


def noisy_warp_2d3d(model, batch, inputs):
    """The Sinkhorn confidences of the noisy GT matrix that the 2D-3D warp
    solves soft Procrustes on, and that solve's condition numbers."""
    import torch

    from diffreg_tpu_torch.diffusion.schedule import q_sample
    from diffreg_tpu_torch.geometry.procrustes import soft_procrustes
    from diffreg_tpu_torch.models.pipeline_2d3d import _matrix_from_indices
    from diffreg_tpu_torch.ops.partition import point_to_node_partition

    cfg = model.cfg
    with torch.no_grad():
        part = point_to_node_partition(batch.points[0], batch.points[-1], batch.masks[0],
                                       batch.masks[-1], cfg.pcd_num_points_in_patch)
        nodes = part.node_masks & (part.node_sizes > cfg.pcd_min_node_size)
        centers, valid = model.patch_centers(batch)
        x = q_sample(model.schedule, _matrix_from_indices(
            batch.gt_src, batch.gt_tgt, batch.gt_valid, nodes.shape[1], valid.shape[1]),
            inputs["t"], inputs["noise"])
        conf = model.denoising_coarse_matching.sinkhorn(x, nodes, valid, batch.masks[-1],
                                                        torch.ones_like(valid))
        res = soft_procrustes(conf, batch.points[-1], centers, nodes, valid,
                              sample_rate=cfg.procrustes_sample_rate,
                              max_condition_num=cfg.procrustes_max_condition,
                              use_masked_lengths=True)
    return conf, nodes, valid, res.condition


def train_step_2d3d_card_vs_cpu(cfg, one, circle_cfg, fine_cfg, tag="2D-3D",
                                rounding=(KEY_BIAS,)):
    """One 2D-3D train step of one pair on the card and on the CPU, from the
    same weights and draws: the loss, every gradient, the noisy matrix's
    top-k cut gap against the two devices' difference there. The gradients
    of the parameters named by ``rounding`` (suffixes) are rounding on both
    devices: held to KEY_BIAS_TOL of the largest entry instead. Returns the
    gaps and the card's seconds."""
    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.losses2d3d import loss_2d3d
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D

    models = {"CPU": DiffReg2D3D(cfg, device="cpu", seed=0),
              "card": DiffReg2D3D(cfg, device="cuda", seed=0)}
    # a draw whose noisy-matrix warp cuts its top-k in a gap wider than the
    # two devices' difference of those confidences
    for seed in range(50):
        inputs = models["CPU"].draw_train_inputs(one, torch.Generator().manual_seed(seed))
        conf, nodes, valid, cond = noisy_warp_2d3d(models["CPU"], one, inputs)
        gap = cut_gap(conf, nodes, valid)
        if gap > CUT_GAP_MIN and abs(float(cond[0]) - cfg.procrustes_max_condition) > 1.0:
            break
    card_conf = noisy_warp_2d3d(models["card"], one.to("cuda"),
                                {k: v.cuda() for k, v in inputs.items()})[0]
    warp_err = float((card_conf.cpu() - conf).abs().max())
    res = {}
    for name, model in models.items():
        dev = "cpu" if name == "CPU" else "cuda"
        batch = one.to(dev)
        t0 = time.perf_counter()
        out = model.train_forward(batch, **{k: v.to(dev) for k, v in inputs.items()})
        loss, info = loss_2d3d(out, circle_cfg, LossConfig(), batch=batch, fine_cfg=fine_cfg)
        params = [p for _, p in model.named_trained_parameters()]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        res[name] = {"loss": float(loss.detach()),
                     "info": {k: float(v.detach()) for k, v in info.items()},
                     "grads": [None if g is None else g.cpu() for g in grads],
                     "seconds": time.perf_counter() - t0}
    cpu, card = res["CPU"], res["card"]
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    names = [n for n, _ in models["CPU"].named_trained_parameters()]
    errs, diff_sq, ref_sq, finite, key_bias = [], 0.0, 0.0, True, 0.0
    largest = max(float(g.abs().max()) for g in cpu["grads"] if g is not None)
    for n, g_card, g_cpu in zip(names, card["grads"], cpu["grads"]):
        if (g_card is None) != (g_cpu is None):
            raise AssertionError(f"2D-3D train step: gradient of {n} is None on one side only")
        if g_cpu is None:
            continue
        finite &= bool(torch.isfinite(g_card).all()) and bool(torch.isfinite(g_cpu).all())
        if n.endswith(rounding):
            # no gradient but rounding on both devices (KEY_BIAS, DEPTH_SCALE)
            key_bias = max(key_bias, float(g_card.abs().max()), float(g_cpu.abs().max()))
            continue
        diff = (g_card - g_cpu).double()
        errs.append((float(diff.abs().max()) / max(float(g_cpu.abs().max()), 1e-30), n))
        diff_sq += float((diff * diff).sum())
        ref_sq += float((g_cpu.double() ** 2).sum())
    errs.sort(reverse=True)
    worst, median = errs[0][0], errs[len(errs) // 2][0]
    global_err = math.sqrt(diff_sq / ref_sq)
    log(f"{tag} train step card vs CPU (1 pair, CPU {cpu['seconds']:.1f} s, card "
        f"{card['seconds']:.2f} s): draw seed {seed}, noisy-warp cut gap {gap:.3e} against the "
        f"devices' difference there {warp_err:.3e}, condition {float(cond[0]):.3f} (gate "
        f"{cfg.procrustes_max_condition}); loss {card['loss']:.6f} vs {cpu['loss']:.6f} (rel err "
        f"{loss_err:.3e}, limit {LOSS_REL_TOL:.0e}); terms " + ", ".join(
            f"{k} {card['info'][k]:.6f}/{cpu['info'][k]:.6f}" for k in LOSS_TERMS_2D3D)
        + f"; gradients of {len(errs)} tensors: worst {worst:.3e} (limit {GRAD_WORST_TOL:.0e}), "
        f"median {median:.3e} (limit {GRAD_MEDIAN_TOL:.0e}), global {global_err:.3e} (limit "
        f"{GRAD_GLOBAL_TOL:.0e}); {', '.join(rounding)} (no gradient but rounding) "
        f"{key_bias / largest:.3e} of the largest gradient entry (limit {KEY_BIAS_TOL:.0e})"
        + "".join(f"; {n} {float(g_card.sum()):.3e} / {float(g_cpu.sum()):.3e}"
                  for n, g_card, g_cpu in zip(names, card["grads"], cpu["grads"])
                  if n == DEPTH_SCALE))
    log("  worst gradient tensors: " + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]))
    if not key_bias <= KEY_BIAS_TOL * largest:
        raise AssertionError(f"{tag} train step: a gradient of {rounding} is {key_bias}")
    if not (gap > CUT_GAP_MIN and gap > 10 * warp_err
            and abs(float(cond[0]) - cfg.procrustes_max_condition) > 1.0):
        raise AssertionError(f"{tag} train step: the warp's top-k cut (gap {gap}, devices "
                             f"{warp_err}) or its gate falls on a near-tie")
    if not finite:
        raise AssertionError(f"{tag} train step: non-finite gradients")
    if not loss_err <= LOSS_REL_TOL:
        raise AssertionError(f"{tag} train step: loss differs from the CPU's by {loss_err}")
    if not (worst <= GRAD_WORST_TOL and median <= GRAD_MEDIAN_TOL
            and global_err <= GRAD_GLOBAL_TOL):
        raise AssertionError(f"{tag} train step: gradients differ from the CPU's (worst {worst}, "
                             f"median {median}, global {global_err})")
    return {"loss": loss_err, "worst": worst, "median": median, "global": global_err,
            "card_s": card["seconds"], "cpu_s": cpu["seconds"]}


def run_cli_train_2d3d(repo, split_root, launches):
    """``diffreg_tpu_torch.main`` on a copy of configs/train/rgbdv2.yaml with
    ``data_root`` at the split (its train subset, augmented) and one epoch: a
    step per pair, the loss terms checked, a checkpoint written."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import load_yaml

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        raw = load_yaml(os.path.join(repo, "configs", "train", "rgbdv2.yaml"))
        raw.update(data_root=split_root, max_epoch=1)
        config = os.path.join(tmp, "train_rgbdv2.yaml")
        with open(config, "w") as f:
            yaml.safe_dump(raw, f)
        os.chdir(tmp)
        try:
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            summary, seconds = wall(lambda: cli(["--config", config, "--mode", "train"]))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            ckpt = os.path.isfile(os.path.join(tmp, "snapshot", raw["exp_dir"], "checkpoints",
                                               "1.pt"))
        finally:
            os.chdir(cwd)
    steps = summary.get("steps")
    if not (steps == BATCH_PAIRS and n_kp == 8 * steps and n_at == TRAIN_ATTENTION_2D3D * steps):
        raise AssertionError(f"main rgbdv2 train: {steps} steps, {n_kp} KPConv, {n_at} attention "
                             "launches")
    if not (ckpt and all(math.isfinite(summary.get(k, math.nan))
                         for k in LOSS_TERMS_2D3D + ("loss",))):
        raise AssertionError(f"main rgbdv2 train: checkpoint {ckpt}, summary {summary}")
    launches["kpconv_train_2d3d"] += n_kp
    launches["masked_attention_train_2d3d"] += n_at
    log(f"main rgbdv2 train (on disk, {BATCH_PAIRS} pairs, batch 1, one epoch): {seconds:.2f} s, "
        f"launches kpconv {n_kp} attention {n_at}; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in summary.items()))


def run_train_2d3d_phase(repo, split_root, launches):
    """Phase 16: the train subset beside the test split, the Trainer, one step
    card against CPU, and the CLI's train path."""
    from diffreg_tpu_torch.main import loss_2d3d_configs, pipeline_2d3d_config
    from diffreg_tpu_torch.utils.config import load_yaml

    raw = load_yaml(os.path.join(repo, "configs", "train", "rgbdv2.yaml"))
    cfg = pipeline_2d3d_config(raw)
    circle_cfg, fine_cfg = loss_2d3d_configs(raw)
    t0 = time.perf_counter()
    write_2d3d_split(split_root, subset="train", seed=8)
    batch_cpu, spec, _, pixels = data_2d3d(split_root, "train", augment=True)
    log(f"2D-3D train split: written, read and collated in {time.perf_counter() - t0:.2f} s; "
        f"spec {spec}; {pixels // 64} image tokens; overlap pairs "
        f"{[int(v.sum()) for v in batch_cpu.ov_valid]}, fine pairs "
        f"{[int(v.sum()) for v in batch_cpu.fine_valid]}")
    result = train_2d3d_trainer(cfg, batch_cpu, circle_cfg, fine_cfg, launches)
    train_step_2d3d_card_vs_cpu(cfg, batch_cpu.select(slice(0, 1)), circle_cfg, fine_cfg)
    run_cli_train_2d3d(repo, split_root, launches)
    return result


# ---------------------------------------------------------------- 2D-3D with the towers


def vit_flops(cfg, tokens):
    """Float operations of one DINOv2 forward over ``tokens`` tokens (the
    matrix products: qkv, attention's two, proj, the MLP's two)."""
    d = cfg.embed_dim
    per_block = 2 * tokens * d * (3 * d + d + 2 * int(d * cfg.mlp_ratio)) + 4 * tokens ** 2 * d
    return cfg.depth * per_block


def seeded_towers():
    """ViT-L/14 DINOv2 and DepthAnything (DPT 256, out channels 256/512/1024/1024)
    on the CPU, with weights from seeds 0 and 1."""
    from diffreg_tpu_torch.models.towers import synthesise_tower_weights
    from diffreg_tpu_torch.nn.depth_anything import DepthAnything, DPTConfig
    from diffreg_tpu_torch.nn.dinov2 import DinoVisionTransformer, vit_large_config

    vit = vit_large_config()
    dino, da = DinoVisionTransformer(vit), DepthAnything(vit, DPTConfig())
    synthesise_tower_weights(dino, 0)
    synthesise_tower_weights(da, 1)
    return dino, da


def check_towers(image_rgb):
    """The seeded towers (``seeded_towers``) on one RGB image [1, H, W, 3]: the card's
    tokens and depth against the CPU's, the times of each tower an image on
    the card (the module alone, and TowerRunner's call with its host copies),
    peak memory. Returns (the card's TowerRunner, the CPU's modules, numbers)."""
    import copy

    import numpy as np
    import torch

    from diffreg_tpu_torch.models.towers import IMAGENET_MEAN, IMAGENET_STD, TowerRunner
    from diffreg_tpu_torch.nn.dinov2 import vit_large_config

    dino, da = seeded_towers()
    cpu = TowerRunner(copy.deepcopy(dino), copy.deepcopy(da), device="cpu")
    t0 = time.perf_counter()
    ref_tokens, ref_depth = cpu.dino_tokens(image_rgb), cpu.mono_depth(image_rgb)
    cpu_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    card = TowerRunner(dino, da, device="cuda")
    tokens, depth = card.dino_tokens(image_rgb), card.mono_depth(image_rgb)
    errs = {}
    for name, got, ref in (("tokens", tokens, ref_tokens), ("depth", depth, ref_depth)):
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"tower {name}: shape {got.shape} vs {ref.shape} or non-finite")
        errs[name] = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        if not errs[name] <= TOWER_REL_TOL:
            raise AssertionError(f"tower {name}: card vs CPU {errs[name]:.3e} of the scale "
                                 f"(limit {TOWER_REL_TOL:.0e})")
    if not float(ref_depth.max()) > 0:
        raise AssertionError("DepthAnything's depth is zero everywhere")
    x = torch.from_numpy(image_rgb).cuda().permute(0, 3, 1, 2).contiguous()
    xn = torch.from_numpy((image_rgb - IMAGENET_MEAN) / IMAGENET_STD).cuda().permute(
        0, 3, 1, 2).contiguous()
    with torch.no_grad():
        dino_ms = time_cuda(lambda: card.dino(x), 5, warmup=1)
        da_ms = time_cuda(lambda: card.depth_anything(xn), 5, warmup=1)
    _, runner_s = wall(lambda: (card.dino_tokens(image_rgb), card.mono_depth(image_rgb)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tokens = (image_rgb.shape[1] // 14) * (image_rgb.shape[2] // 14) + 1
    vit = vit_large_config()
    flops = vit_flops(vit, n_tokens)
    out = {"dino_ms": dino_ms, "depth_anything_ms": da_ms, "runner_ms": runner_s * 1e3,
           "peak_gib": peak, "tokens_rel_err": errs["tokens"], "depth_rel_err": errs["depth"],
           "vit_tflop": flops / 1e12}
    log(f"towers (ViT-L/14, weights from a seed) on one {image_rgb.shape[1]} x "
        f"{image_rgb.shape[2]} image, f32 with TF32 off: DINOv2 {dino_ms:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP of matrix products, {flops / dino_ms / 1e9:.1f} TFLOP/s), "
        f"DepthAnything {da_ms:.3f} ms, TowerRunner's two calls with host copies "
        f"{runner_s * 1e3:.1f} ms; card vs CPU: tokens {errs['tokens']:.3e}, depth "
        f"{errs['depth']:.3e} of the scale (limit {TOWER_REL_TOL:.0e}); CPU {cpu_s:.1f} s; "
        f"peak memory {peak:.2f} GiB")
    return card, cpu, out


def run_cli_dino(repo, split_root, cpu_towers, launches):
    """``diffreg_tpu_torch.main`` on a written copy of configs/test/
    rgbdv2_dino.yaml: ``towers`` at the seeded towers' state_dicts, the split
    under ``split_root`` and a checkpoint of random weights; its summary,
    eval_from_cache and launches checked."""
    import tempfile

    import torch
    import yaml

    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import load_yaml

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        raw = load_yaml(os.path.join(repo, "configs", "test", "rgbdv2_dino.yaml"))
        raw.update(data_root=split_root, exp_dir="disk-rgbdv2-dino",
                   pretrain=os.path.join(tmp, "ckpt"),
                   towers={"dinov2": os.path.join(tmp, "dinov2.pth"),
                           "depth_anything": os.path.join(tmp, "depth_anything.pth")})
        t0 = time.perf_counter()
        torch.save(cpu_towers.dino.state_dict(), raw["towers"]["dinov2"])
        torch.save(cpu_towers.depth_anything.state_dict(), raw["towers"]["depth_anything"])
        CheckpointManager(raw["pretrain"]).save(1, create_train_state(
            DiffReg2D3D(pipeline_2d3d_config(raw), device="cpu", seed=0), OptimConfig()))
        path = os.path.join(tmp, "rgbdv2_dino.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        write_s = time.perf_counter() - t0
        os.chdir(tmp)
        try:
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            argv = ["--config", path, "--num-pairs", str(BATCH_PAIRS), "--batch-size",
                    str(BATCH_PAIRS)]
            summary, seconds = wall(lambda: cli(argv))
        finally:
            os.chdir(cwd)
    n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
    steps = int(raw["SAMPLE_STEP"])
    if n_kp != 8 or n_at != 12 * (1 + steps):
        raise AssertionError(f"main rgbdv2_dino: {n_kp} KPConv, {n_at} attention launches")
    ev = summary.get("eval", {})
    if not (summary["pairs"] == BATCH_PAIRS and all(
            math.isfinite(summary[k]) for k in ("IR", "PIR", "RR", "RRE", "RTE"))
            and sorted(ev.get("scenes", {})) == ["scene_00", "scene_01"]
            and math.isfinite(ev.get("PIR", math.nan))):
        raise AssertionError(f"main rgbdv2_dino: summary {summary}")
    launches["kpconv"] += n_kp
    launches["kpconv_2d3d"] += n_kp
    launches["masked_attention_d64_dino"] += n_at
    log(f"main rgbdv2_dino test (on disk, towers from state_dicts, {BATCH_PAIRS} pairs): "
        f"{seconds:.2f} s (the towers' and checkpoint's files written in {write_s:.1f} s), "
        f"launches kpconv {n_kp} attention {n_at}; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in summary.items() if k != "eval"))


def run_dino_phase(repo, split_root, kernels, launches, gen):
    """Phase 17, the published model (configs/test/rgbdv2_dino.yaml): the towers
    card against CPU, the split at stride 14 with the card's tower outputs,
    both kernels at its shapes, the path through TwoDThreeDTester, pair 0 on
    the CPU, PnP, and the CLI on a copy of the YAML."""
    import torch

    from diffreg_tpu_torch.data.datasets2d3d import RGBDScenes2D3DPairDataset
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.nn.point_backbone import KPConvBias
    from diffreg_tpu_torch.utils.config import load_yaml

    cfg = pipeline_2d3d_config(load_yaml(os.path.join(repo, "configs", "test",
                                                      "rgbdv2_dino.yaml")))
    s = cfg.coarse_stride
    image = RGBDScenes2D3DPairDataset(split_root, "test")[0]["image"]
    image = image[:image.shape[0] // s * s, :image.shape[1] // s * s][None]
    card, cpu_towers, tower_numbers = check_towers(image)
    t0 = time.perf_counter()
    batch_cpu, _, scenes, pixels = data_2d3d(split_root, stride=s, towers=card)
    n_tokens = pixels // (s * s)
    log(f"2D-3D dino data: read, calibrated, collated with the towers' outputs in "
        f"{time.perf_counter() - t0:.2f} s; image {tuple(batch_cpu.image.shape)}, {n_tokens} "
        f"image tokens, dino_feats {tuple(batch_cpu.dino_feats.shape)}, mono_depth "
        f"{tuple(batch_cpu.mono_depth.shape)}")
    train_cpu = data_2d3d(split_root, "train", augment=True, stride=s, towers=card)[0]
    del card

    batch = batch_cpu.to("cuda")
    model = DiffReg2D3D(cfg, device="cuda", seed=0)
    kp, _ = check_kpconv(
        kpconv_layer_calls(model, lambda: model.pcd_backbone(batch), KPConvBias), 8,
        "one point-backbone pass (8 calls)", tag=" (2D-3D dino)")
    kernels[0]["2d3d_dino"] = {k: kp[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "per")}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], kp["max_abs_err"])
    del model, batch
    torch.cuda.empty_cache()
    at, at_shapes, _ = check_attention_2d3d(batch_cpu, n_tokens, cfg, gen)
    kernels[1]["d64_dino"] = at
    kernels[1]["shapes"] += [dict(row, case=row["case"].replace("(2D-3D)", "(2D-3D dino)"))
                             for row in at_shapes]
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], at["max_abs_err"])

    result = run_2d3d(batch_cpu, scenes, cfg, launches, gen, key="masked_attention_d64_dino",
                      tag="2D-3D dino", config="configs/test/rgbdv2_dino.yaml")
    kernels[1]["d64_dino"]["path"] = {**result, "towers": tower_numbers}
    run_cli_dino(repo, split_root, cpu_towers, launches)

    # the dino model's train step (the train subset with the card's tower
    # outputs, configs/train/rgbdv2.yaml's optimizer): a Trainer epoch, then
    # pair 0 card against CPU at the 2D-3D train limits
    from diffreg_tpu_torch.main import loss_2d3d_configs

    circle_cfg, fine_cfg = loss_2d3d_configs(load_yaml(os.path.join(
        repo, "configs", "test", "rgbdv2_dino.yaml")))
    train = train_2d3d_trainer(cfg, train_cpu, circle_cfg, fine_cfg, launches,
                               tag="2D-3D dino train (configs/test/rgbdv2_dino.yaml")
    train["pair0"] = train_step_2d3d_card_vs_cpu(cfg, train_cpu.select(slice(0, 1)), circle_cfg,
                                                 fine_cfg, tag="2D-3D dino",
                                                 rounding=(KEY_BIAS, DEPTH_SCALE))
    kernels[1]["d64_dino"]["train"] = train


def run_2d3d_phases(repo, kernels, launches, gen):
    """Phases 12-17: the kernels at the 2D-3D shapes, the 2D-3D path, pair 0 on
    the CPU, PnP, the CLI on the 2D-3D configs, 2D-3D training, and the
    published model with its towers. Returns the split's batch (CPU tensors)
    and spec for phase 24."""
    import tempfile

    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.nn.point_backbone import KPConvBias
    from diffreg_tpu_torch.utils.config import load_yaml

    cfg = pipeline_2d3d_config(load_yaml(os.path.join(repo, "configs", "test", "rgbdv2.yaml")))
    with tempfile.TemporaryDirectory() as split_root:
        t0 = time.perf_counter()
        write_2d3d_split(split_root)
        t1 = time.perf_counter()
        batch_cpu, spec, scenes, pixels = data_2d3d(split_root)
        n_tokens = pixels // 64
        log(f"2D-3D data: split written in {t1 - t0:.2f} s, read, calibrated and collated in "
            f"{time.perf_counter() - t1:.2f} s; spec {spec}; image {tuple(batch_cpu.image.shape)}"
            f", {n_tokens} image tokens; real nodes "
            f"{[int(m.sum()) for m in batch_cpu.masks[-1]]} of {batch_cpu.masks[-1].shape[1]}")

        # ---- 12. the kernels at the 2D-3D shapes ----
        batch = batch_cpu.to("cuda")
        model = DiffReg2D3D(cfg, device="cuda", seed=0)
        kp, kp_shapes = check_kpconv(
            kpconv_layer_calls(model, lambda: model.pcd_backbone(batch), KPConvBias), 8,
            "one point-backbone pass (8 calls)", tag=" (2D-3D)")
        kernels[0]["shapes_2d3d"] = kp["shapes"]
        kernels[0]["2d3d"] = {k: kp[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "per")}
        key = max(kp_shapes, key=lambda s: s[3])                 # the widest layer
        err, back = kpconv_gradients({key: kp_shapes[key]}, gen)
        kernels[0]["2d3d"].update({"backward_ms_widest_layer": back, "backward_max_rel_err": err})
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], kp["max_abs_err"])
        del kp_shapes, model, batch
        at, at_shapes, cases = check_attention_2d3d(batch_cpu, n_tokens, cfg, gen)
        err, per_call, per_pass = attention_gradients_2d3d(cases, cfg, gen)
        at.update({"backward_ms": per_pass, "backward_ms_per_call": per_call,
                   "backward_max_rel_err": err})
        kernels[1]["d64"] = at
        kernels[1]["shapes"] += at_shapes
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], at["max_abs_err"])
        del cases

        # ---- 13-14. the 2D-3D path; pair 0 on the CPU; PnP ----
        run_2d3d(batch_cpu, scenes, cfg, launches, gen)

        # ---- 15. the entry point on the 2D-3D configs ----
        run_cli_2d3d(repo, split_root, launches)

        # ---- 16. 2D-3D training: the Trainer, card vs CPU, the entry point ----
        kernels[1]["d64"]["train_2d3d"] = run_train_2d3d_phase(repo, split_root, launches)

        # ---- 17. the published model: the towers, rgbdv2_dino.yaml's path, the CLI ----
        run_dino_phase(repo, split_root, kernels, launches, gen)
    return batch_cpu, spec


# ---------------------------------------------------------------- the synthetic training story


def story_tool(repo, name="train_synthetic_port"):
    """tools/<name>.py (a synthetic training story's tool) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(repo, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_story_kernels(tool, gen, batch=None, tag="story"):
    """Phase 18a (and 20a): both bf16 instances at a story model's shapes
    (tools/train_synthetic_port.py: 8 pairs of 512 tokens a side, 4 heads of
    24, KPConv at K 16 over its 11 layers) on pool batch 0 (``batch``, else the
    3D story's) with the model's seeded weights: each against its plain bf16
    version, forward and gradient through its autograd Function. Returns the
    two entries for the JSON line's ``story`` keys."""
    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.nn.kpfcn import KPConv

    if batch is None:
        batch = synthetic_batch(batch_size=STORY_BATCH, n_points=tool.N_POINTS, seed=0)[0]
    batch = batch.to("cuda")
    model = tool.build_model("cuda")
    kp, kp_shapes = check_kpconv(kpconv_layer_calls(model, lambda: model.encode(batch), KPConv),
                                 11, f"one {tag} encode (11 calls)", f" (bf16, {tag})", bf16=True)
    worst, ms = kpconv_gradients(kp_shapes, gen, bf16=True)
    kp.update(backward_ms=ms, backward_max_rel_err=worst)
    at = check_attention(batch, model.cfg, gen, f" (bf16, {tag})", bf16=True)
    worst, ms = attention_gradients(batch, model.cfg, gen, bf16=True)
    at.update(backward_ms=ms, backward_max_rel_err=worst)
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "per",
            "shapes", "backward_ms", "backward_max_rel_err")
    return {k: kp[k] for k in keep}, {k: at[k] for k in keep}


def run_story_trained(repo, tool, launches):
    """Phase 18b: the committed trained weights (STORY_PARAMS) in the story
    model on the card. The DDIM + RANSAC eval of the 32 test pairs, its bf16
    launches counted, success and IR printed beside metrics.json's (success
    at least STORY_SUCCESS_MIN); then pair 0 of the test split at batch 1,
    card against CPU in bf16 and in f32 (story_pair0_check)."""
    import numpy as np
    import torch

    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16

    path = os.path.join(repo, STORY_PARAMS)
    with open(os.path.join(os.path.dirname(path), "metrics.json")) as f:
        recorded = json.load(f)
    model = tool.load_params(tool.build_model("cuda"), path)
    heldout = tool.split_batches(tool.TEST_SEED, tool.TEST_BATCHES, STORY_BATCH, tool.N_POINTS,
                                 "cuda")
    split_success = tool.make_split_success(model)
    split_success(heldout[:1])                                            # warm-up
    kernels = (kpconv_cuda_bf16, masked_attention_cuda_bf16, kpconv_cuda, masked_attention_cuda)
    for fn in kernels:
        fn.launches = 0
    (success, rres, ir), seconds = wall(lambda: split_success(heldout))
    n_kp, n_at, n_f32 = kpconv_cuda_bf16.launches, masked_attention_cuda_bf16.launches, \
        kpconv_cuda.launches + masked_attention_cuda.launches
    steps = model.cfg.sample_steps
    per_step = attention_calls(tool.N_POINTS, tool.N_POINTS, model.cfg.denoising_layer_types)
    if n_kp != 11 * len(heldout) or n_at != per_step * steps * len(heldout) or n_f32:
        raise AssertionError(f"story eval: {n_kp} bf16 KPConv, {n_at} bf16 attention, "
                             f"{n_f32} f32 launches")
    launches["kpconv_bf16_story"] += n_kp
    launches["masked_attention_bf16_story"] += n_at
    pairs = len(heldout) * STORY_BATCH
    log(f"story, trained weights ({STORY_PARAMS}, selected step {recorded['selected_step']}): "
        f"{pairs} test pairs through DDIM ({steps} steps) + RANSAC in {seconds:.3f} s "
        f"({pairs / seconds:.3f} pairs/s): success@5deg {success:.4f} (metrics.json "
        f"{recorded['heldout_success_after']:.4f}, limit {STORY_SUCCESS_MIN}), IR {ir:.4f} "
        f"(metrics.json {recorded['heldout_ir_after']:.4f}); median RRE {np.median(rres):.3f} "
        f"deg; launches bf16 kpconv {n_kp} attention {n_at}, f32 0")
    if not success >= STORY_SUCCESS_MIN:
        raise AssertionError(f"story: test success {success} with the trained weights")

    # ---- pair 0 of the test split at batch 1, card against CPU ----
    one = tool.split_batches(tool.TEST_SEED, 1, STORY_BATCH, tool.N_POINTS, "cpu")[0]
    x_init = tool.eval_draws(one)[0][:1]
    one = one.select(slice(0, 1))
    f32_cfg = dataclasses.replace(
        model.cfg, kpfcn=dataclasses.replace(model.cfg.kpfcn, compute_dtype=None),
        coarse_transformer=dataclasses.replace(model.cfg.coarse_transformer, compute_dtype=None))
    f32_model = tool.load_params(DiffusionMatchingModel(f32_cfg, device="cuda"), path)
    pair0 = {}
    for name, card_model, cpu_model, rel_tol in (
            ("bf16", model, tool.build_model("cpu"), STORY_CONF_BF16_REL_TOL),
            ("f32", f32_model, DiffusionMatchingModel(f32_cfg, device="cpu"),
             STORY_CONF_F32_REL_TOL)):
        tool.load_params(cpu_model, path)
        with torch.no_grad():
            got = card_model.ddim_sample(one.to("cuda"), x_init.cuda())
            t0 = time.perf_counter()
            ref = cpu_model.ddim_sample(one, x_init)
            cpu_s = time.perf_counter() - t0
        pair0[name] = story_pair0_check(
            name, got, ref, one.src_mask[:, :, None] & one.tgt_mask[:, None, :], one.src_mask,
            rel_tol, cpu_s)
        pair0[name + "_conf"] = got["conf_matrix_pred"].cpu()
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    gap = float((pair0.pop("bf16_conf") - pair0.pop("f32_conf")).abs()[valid].max())
    log(f"story pair 0 on the card, bf16 vs f32: {gap / pair0['f32']['top']:.3e} of the "
        f"largest confidence (f32 limit {STORY_CONF_F32_REL_TOL}, bf16 limit "
        f"{STORY_CONF_BF16_REL_TOL})")
    return {"test_pairs": pairs, "success": success, "ir": ir, "seconds": seconds,
            "recorded_success": recorded["heldout_success_after"],
            "recorded_ir": recorded["heldout_ir_after"], "pair0": pair0,
            "pair0_bf16_vs_f32_rel": gap / pair0["f32"]["top"]}


def story_pair0_check(name, got, ref, valid, rows, rel_tol, cpu_s):
    """A story's test pair 0, card (``got``) against CPU (``ref``) at batch 1:
    the confidences on the ``valid`` entries within ``rel_tol`` of the
    largest, at least TIE_FREE_ROWS_MIN of the real rows (``rows`` [1, N])
    free of a near-tie (best two CPU confidences within twice that limit), and
    on those rows at most MASK_DIFFER_SHARE of the CPU's union-mask entries
    (plus 2) differing."""
    import torch

    conf = ref["conf_matrix_pred"]
    top = float(conf[valid].max())
    limit = rel_tol * top
    conf_err = float((got["conf_matrix_pred"].cpu() - conf).abs()[valid].max())
    top2 = torch.where(valid, conf, torch.full_like(conf, -1.0)).topk(2, dim=2).values
    tie_free = ((top2[..., 0] - top2[..., 1]) > 2 * limit)[0] & rows[0]          # [N]
    real = int(rows[0].sum())
    share = float(tie_free.sum()) / max(real, 1)
    mask, ref_mask = got["corr_mask"].cpu()[0], ref["corr_mask"][0]
    differ = int(((mask != ref_mask) & valid[0])[tie_free].sum())
    cap = MASK_DIFFER_SHARE * int(ref_mask[tie_free].sum()) + 2
    log(f"story pair 0 card vs CPU ({name}, trained weights, batch 1, CPU {cpu_s:.1f} s): conf "
        f"{conf_err:.3e} = {conf_err / top:.3e} of the largest (limit {rel_tol}, max conf "
        f"{top:.3e}); real rows free of a near-tie {share:.4f} of {real} (limit "
        f"{TIE_FREE_ROWS_MIN}); on them {differ} union-mask entries differ of the CPU's "
        f"{int(ref_mask[tie_free].sum())} (cap {cap:.0f}); all rows: "
        f"{int(((mask != ref_mask) & valid[0]).sum())} differ")
    if not conf_err <= limit:
        raise AssertionError(f"story pair 0 ({name}): confidences differ from the CPU's by "
                             f"{conf_err / top:.3e} of the largest")
    if not share >= TIE_FREE_ROWS_MIN:
        raise AssertionError(f"story pair 0 ({name}): only {share} of the real rows are free "
                             "of a near-tie with the trained weights")
    if not differ <= cap:
        raise AssertionError(f"story pair 0 ({name}): {differ} mask entries differ on the "
                             "tie-free rows")
    return {"top": top, "conf_rel_err": conf_err / top, "tie_free_share": share,
            "mask_differ_tie_free": differ, "mask_cap": cap, "real_rows": real}


# ------------------------------------------------------- the 2D-3D synthetic training story


def ddim_cut_gaps_2d3d(model, batch, x_init):
    """The 2D-3D DDIM of ``batch`` from ``x_init`` on the model's device, and
    per DDIM step the gap at soft Procrustes' top-k cut in the node warp (the
    Sinkhorn confidences of the noisy matrix; ``cut_gap``). Returns (out,
    gaps)."""
    import torch

    warp = model._warp_nodes
    gaps = []

    def recording(x, nodes, centers, node_masks, center_masks, node_pad):
        conf = model.denoising_coarse_matching.sinkhorn(
            x, node_masks, center_masks, node_pad, torch.ones_like(center_masks))
        gaps.append(cut_gap(conf, node_masks, center_masks))
        return warp(x, nodes, centers, node_masks, center_masks, node_pad)

    model._warp_nodes = recording
    try:
        with torch.no_grad():
            out = model(batch, mode="ddim", x_init=x_init)
    finally:
        del model._warp_nodes
    return out, gaps


def story2d3d_start(model, one, n_tries=STORY2D3D_START_TRIES):
    """Test pair 0's DDIM start [1, N, M]: the first of the CPU generator's
    seeds 1, 2, ... whose DDIM on the card keeps every step's top-k cut gap
    at least CUT_GAP_MIN. Returns (seed, x_init, the card's gaps)."""
    import torch

    n = one.points[-1].shape[1]
    s = model.cfg.coarse_stride
    m = (one.image.shape[1] // s) * (one.image.shape[2] // s)
    for seed in range(1, n_tries + 1):
        x = torch.randn((1, n, m), generator=torch.Generator().manual_seed(seed))
        _, gaps = ddim_cut_gaps_2d3d(model, one.to("cuda"), x.cuda())
        if min(gaps) >= CUT_GAP_MIN:
            return seed, x, gaps
    raise AssertionError(f"story 2D-3D pair 0: no start of seeds 1-{n_tries} keeps its top-k "
                         f"cut gaps at least {CUT_GAP_MIN}")


def fine_agreement(got_corrs, got_pairs, ref, one, tcfg, stride):
    """The card's fine matches of pair 0 against the CPU's fine matching of
    its own features on the card's coarse correspondences: (card count, CPU
    count, shared share of the union)."""
    import torch

    from diffreg_tpu_torch.models.pipeline_2d3d import fine_matching, patch_pixel_table
    from diffreg_tpu_torch.ops.vision import create_meshgrid

    h, w = one.image.shape[1:3]
    table = torch.from_numpy(patch_pixel_table(h, w, stride))
    pix = create_meshgrid(h, w, flatten=True).flip(-1).contiguous()
    part = ref["partition"]
    fm_ref = fine_matching(
        ref["img_feats_f"][0], one.img_points[0], pix, ref["pcd_feats_f"][0], one.points[0][0],
        got_corrs.src_idx[0].cpu(), got_corrs.tgt_idx[0].cpu(), got_corrs.valid[0].cpu(),
        part.node_knn_indices[0], part.node_knn_masks[0], table, tcfg.max_fine_corr,
        topk=tcfg.fine_topk, threshold=tcfg.fine_threshold)

    def fine_set(fm):
        v = fm["corr_valid"].cpu()
        return set(zip(fm["img_corr_indices"].cpu()[v].tolist(),
                       fm["pcd_corr_indices"].cpu()[v].tolist()))
    fg, fr = fine_set(got_pairs[0]["fm"]), fine_set(fm_ref)
    return len(fg), len(fr), len(fg & fr) / max(len(fg | fr), 1)


def run_story2d3d_kernels(model, batch_cpu, gen):
    """Phase 19a: both f32 kernels at the 2D-3D story model's shapes
    (tools/train_synthetic_2d3d_port.py: 4 pairs, 1024 points a level at K
    16, 88 image tokens, 4 heads of 32) on pool batch 0 with the trained
    weights: KPConv at every distinct point-backbone layer and attention in
    the fusion's four shapes (instance 64), each against its plain version,
    forward and gradient through its autograd Function, with SDPA's time.
    Returns the two entries for the JSON line's ``story_2d3d`` keys."""
    from diffreg_tpu_torch.nn.point_backbone import KPConvBias

    batch = batch_cpu.to("cuda")
    kp, kp_shapes = check_kpconv(
        kpconv_layer_calls(model, lambda: model.pcd_backbone(batch), KPConvBias), 8,
        "one story point-backbone pass (8 calls)", tag=" (2D-3D story)")
    worst, ms = kpconv_gradients(kp_shapes, gen)
    kp.update(backward_ms=ms, backward_max_rel_err=worst)
    s = model.cfg.coarse_stride
    n_tokens = (batch.image.shape[1] // s) * (batch.image.shape[2] // s)
    at, at_shapes, cases = check_attention_2d3d(batch_cpu, n_tokens, model.cfg, gen,
                                                tag=" (2D-3D story)")
    worst, per_call, per_pass = attention_gradients_2d3d(cases, model.cfg, gen,
                                                         tag=" (2D-3D story)")
    at.update(shapes=at_shapes, backward_ms=per_pass, backward_ms_per_call=per_call,
              backward_max_rel_err=worst)
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "per",
            "shapes", "backward_ms", "backward_max_rel_err")
    return {k: kp[k] for k in keep}, {k: at[k] for k in keep}


def run_story2d3d(repo, kernels, launches, gen):
    """Phase 19: the 2D-3D synthetic training story's committed trained
    weights (STORY2D3D_PARAMS) on the card. 19a: the kernels at its shapes
    (run_story2d3d_kernels). 19b: the reference protocol's eval of the 16
    test pairs (DDIM, fine matching, PnP), launches counted, RR, IR and FMR
    within STORY2D3D_METRIC_TOL of metrics.json's. 19c: test pair 0 at batch
    1, card against CPU through the tester with the same weights and draws
    (a start whose top-k cut gaps stay at least CUT_GAP_MIN at every DDIM
    step, the PnP draws passed in): the DDIM output's confidences within
    STORY2D3D_CONF_REL_TOL of the largest, the tie-free share and the mask
    cap on the real node rows (story_pair0_check), and the fine matches."""
    import torch

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    tool = story_tool(repo, "train_synthetic_2d3d_port")
    path = os.path.join(repo, STORY2D3D_PARAMS)
    with open(os.path.join(os.path.dirname(path), "metrics.json")) as f:
        recorded = json.load(f)
    model = tool.load_params(tool.build_model("cuda"), path)

    # ---- 19a. the kernels at the story's shapes ----
    kernels[0]["story_2d3d"], kernels[1]["story_2d3d"] = run_story2d3d_kernels(
        model, tool.make_batch(STORY2D3D_BATCH, 0), gen)

    # ---- 19b. the trained weights' eval of the test split ----
    heldout = tool.split_batches(tool.TEST_SEED, tool.TEST_BATCHES, STORY2D3D_BATCH, "cuda")
    split_eval = tool.make_split_eval(model)
    split_eval(heldout[:1])                                                # warm-up
    kpconv_cuda.launches = 0
    masked_attention_cuda.launches = 0
    (rr, ir, fmr), seconds = wall(lambda: split_eval(heldout))
    n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
    steps = model.cfg.sample_steps
    if n_kp != 8 * len(heldout) or n_at != 12 * (1 + steps) * len(heldout):
        raise AssertionError(f"2D-3D story eval: {n_kp} KPConv, {n_at} attention launches")
    launches["kpconv_story_2d3d"] += n_kp
    launches["masked_attention_story_2d3d"] += n_at
    pairs = len(heldout) * STORY2D3D_BATCH
    scores = {"RR": rr, "IR": ir, "FMR": fmr}
    want = {k: recorded[f"heldout_{k.lower()}_after"] for k in scores}
    log(f"2D-3D story, trained weights ({STORY2D3D_PARAMS}, selected step "
        f"{recorded['selected_step']}): {pairs} test pairs through DDIM ({steps} steps), fine "
        f"matching and PnP in {seconds:.3f} s ({pairs / seconds:.3f} pairs/s): "
        + ", ".join(f"{k} {scores[k]:.4f} (metrics.json {want[k]:.4f})" for k in scores)
        + f", limit {STORY2D3D_METRIC_TOL:.4f}; launches kpconv {n_kp} attention {n_at}")
    if not all(abs(scores[k] - want[k]) <= STORY2D3D_METRIC_TOL for k in scores):
        raise AssertionError(f"2D-3D story eval {scores} against metrics.json's {want}")

    # ---- 19c. test pair 0, card against CPU, the DDIM output ----
    one = heldout[0].select(slice(0, 1)).to("cpu")
    seed, x_init, card_gaps = story2d3d_start(model, one)
    u = torch.rand((1, tool.TEST_CONFIG.pnp_hypotheses, 6),
                   generator=torch.Generator().manual_seed(STORY2D3D_PNP_SEED))
    cpu_model = tool.load_params(tool.build_model("cpu"), path)
    res = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        t = fixed_draws_tester(m, tool.TEST_CONFIG, dev, x_init, u)
        t0 = time.perf_counter()
        with torch.inference_mode():
            res[dev] = t.forward(one.to(dev), None)
        res[dev + "_s"] = time.perf_counter() - t0
    _, cpu_gaps = ddim_cut_gaps_2d3d(cpu_model, one, x_init)
    (got, got_corrs, got_pairs), (ref, _, ref_pairs) = res["cuda"], res["cpu"]
    valid = ref["node_masks"][:, :, None] & ref["img_valid_c"][:, None, :]
    log(f"2D-3D story pair 0: start seed {seed}; top-k cut gaps per DDIM step, card "
        f"{min(card_gaps):.3e} to {max(card_gaps):.3e}, CPU {min(cpu_gaps):.3e} to "
        f"{max(cpu_gaps):.3e} (limit {CUT_GAP_MIN:.0e}); card {res['cuda_s']:.2f} s")
    check = story_pair0_check("2D-3D f32, DDIM output", got, ref, valid, ref["node_masks"],
                              STORY2D3D_CONF_REL_TOL, res["cpu_s"])
    n_got, n_ref, shared = fine_agreement(got_corrs, got_pairs, ref, one, tool.TEST_CONFIG,
                                          model.cfg.coarse_stride)
    log(f"2D-3D story pair 0 fine matches on the card's coarse ones: {n_got} vs {n_ref}, shared "
        f"{shared:.4f} of the union (limit {FINE_2D3D_AGREEMENT}); IR "
        f"{float(got_pairs[0]['IR']):.4f} vs {float(ref_pairs[0]['IR']):.4f}, matches "
        f"{int(got_pairs[0]['n_corr'])} vs {int(ref_pairs[0]['n_corr'])}")
    if n_ref and shared < FINE_2D3D_AGREEMENT:
        raise AssertionError(f"2D-3D story pair 0: fine matches share {shared} of the union")
    return {"test_pairs": pairs, "seconds": seconds, **{k.lower(): v for k, v in scores.items()},
            "recorded": want, "pair0": {**check, "start_seed": seed,
                                        "cut_gap_min": min(card_gaps + cpu_gaps),
                                        "fine_shared": shared}}


# ------------------------------------------------------- the 4DMatch synthetic training story


def ddim_cut_gaps_4d(model, batch, x_init, noise):
    """The 4DMatch DDIM of ``batch`` from ``x_init`` and per-step ``noise`` on
    the model's device, and per DDIM step the gap at soft Procrustes' top-k
    cut in the gated warp (the Sinkhorn confidences of the noisy matrix;
    ``cut_gap``). Returns (out, gaps)."""
    import torch

    warp = model._warp_from_noisy_matrix
    gaps = []

    def recording(x, s_pcd, t_pcd, src_mask, tgt_mask):
        conf = model.denoising_coarse_matching.sinkhorn(x, src_mask, tgt_mask)
        gaps.append(cut_gap(conf, src_mask, tgt_mask))
        return warp(x, s_pcd, t_pcd, src_mask, tgt_mask)

    model._warp_from_noisy_matrix = recording
    try:
        with torch.no_grad():
            out = model.ddim_sample(batch, x_init, ddim_noise=noise)
    finally:
        del model._warp_from_noisy_matrix
    return out, gaps


def story4d_draw(model, one, n_tries=STORY4D_DRAW_TRIES):
    """Test pair 0's DDIM draws: the first of the CPU generator's seeds 1, 2,
    ... whose start [1, S, T] and per-step noise [steps, 1, S, T] keep, in the
    card's DDIM, every step's Procrustes condition at least STORY4D_GATE_CLEAR
    from the gate and every top-k cut gap at least CUT_GAP_MIN. Returns (seed,
    x_init, noise, the card's gaps, the card's smallest distance to the
    gate)."""
    import torch

    shape = (1, one.src_mask.shape[1], one.tgt_mask.shape[1])
    gate = model.cfg.procrustes.max_condition_num
    for seed in range(1, n_tries + 1):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(shape, generator=g)
        noise = torch.randn((model.cfg.sample_steps,) + shape, generator=g)
        out, gaps = ddim_cut_gaps_4d(model, one.to("cuda"), x.cuda(), noise.cuda())
        clear = float((out["step_condition"] - gate).abs().min())
        if min(gaps) >= CUT_GAP_MIN and clear >= STORY4D_GATE_CLEAR:
            return seed, x, noise, gaps, clear
    raise AssertionError(f"story 4D pair 0: no draw of seeds 1-{n_tries} keeps its cut gaps at "
                         f"least {CUT_GAP_MIN} and its conditions {STORY4D_GATE_CLEAR} from the "
                         "gate")


def story4d_pair0_check(name, tool, got, ref, one, metric, limits, cpu_s):
    """Test pair 0 of the 4DMatch story, card (``got``) against CPU (``ref``)
    at batch 1: the sigmoid confidences on valid entries within
    ``limits["conf"]`` of the largest, the pose within ``limits["pose"]``; at
    the protocol's threshold 0.55 at least one match, at least
    TIE_FREE_ROWS_MIN of the real source rows free of a near-tie (best two
    CPU confidences within twice the limit) and of a best confidence within
    twice the limit of 0.55, on those rows at most MASK_DIFFER_SHARE of the
    CPU's thr-mutual entries (plus 2) differing; IR and NFMR within
    METRIC_4D_ABS_TOL."""
    import torch

    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    got = {k: v.cpu() for k, v in got.items()}
    conf = ref["conf_matrix_pred"]
    top = float(conf[valid].max())
    near = 2 * limits["conf"] * top
    conf_err = float((got["conf_matrix_pred"] - conf).abs()[valid].max())
    pose_err = max(float((got[k] - ref[k]).abs().max())
                   for k in ("rotation_pred", "translation_pred"))
    top2 = torch.where(valid, conf, torch.full_like(conf, -1.0)).topk(2, dim=2).values[0]
    tie_free = ((top2[:, 0] - top2[:, 1]) > near) & ((top2[:, 0] - tool.MATCH_THR).abs() > near)
    tie_free &= one.src_mask[0]
    real = int(one.src_mask[0].sum())
    share = float(tie_free.sum()) / max(real, 1)
    mask, ref_mask = tool.match_mask(got, one)[0], tool.match_mask(ref, one)[0]
    differ_all = mask != ref_mask
    differ = int(differ_all[tie_free].sum())
    cap = MASK_DIFFER_SHARE * int(ref_mask[tie_free].sum()) + 2
    (ir, nf, n), (ref_ir, ref_nf, ref_n) = (
        (float(v[0]) for v in tool.pair_metrics(o, one, metric)) for o in (got, ref))
    log(f"story 4D pair 0 card vs CPU ({name}, trained weights, batch 1, CPU {cpu_s:.1f} s): "
        f"sigmoid conf {conf_err:.3e} = {conf_err / top:.3e} of the largest (limit "
        f"{limits['conf']}, max conf {top:.4f}), pose {pose_err:.3e} (limit {limits['pose']}); "
        f"at threshold {tool.MATCH_THR}: matches {int(n)} vs {int(ref_n)}, real rows free of a "
        f"near-tie and of the threshold {share:.4f} of {real} (limit {TIE_FREE_ROWS_MIN}), on "
        f"them {differ} thr-mutual entries differ of the CPU's {int(ref_mask[tie_free].sum())} "
        f"(cap {cap:.0f}), all rows {int(differ_all.sum())}; IR {ir:.5f} vs {ref_ir:.5f}, NFMR "
        f"{nf:.5f} vs {ref_nf:.5f} (limit {METRIC_4D_ABS_TOL})")
    if not conf_err <= limits["conf"] * top:
        raise AssertionError(f"story 4D pair 0 ({name}): confidences differ from the CPU's by "
                             f"{conf_err / top:.3e} of the largest")
    if not pose_err <= limits["pose"]:
        raise AssertionError(f"story 4D pair 0 ({name}): pose differs by {pose_err}")
    if not (n >= 1 and ref_n >= 1):
        raise AssertionError(f"story 4D pair 0 ({name}): no match at {tool.MATCH_THR}")
    if not share >= TIE_FREE_ROWS_MIN:
        raise AssertionError(f"story 4D pair 0 ({name}): only {share} of the real rows are free "
                             "of a near-tie and of the threshold")
    if not differ <= cap:
        raise AssertionError(f"story 4D pair 0 ({name}): {differ} mask entries differ on the "
                             "tie-free rows")
    if not (abs(ir - ref_ir) <= METRIC_4D_ABS_TOL and abs(nf - ref_nf) <= METRIC_4D_ABS_TOL):
        raise AssertionError(f"story 4D pair 0 ({name}): IR or NFMR differ from the CPU's")
    return {"top": top, "conf_rel_err": conf_err / top, "pose_err": pose_err,
            "tie_free_share": share, "real_rows": real, "mask_differ_tie_free": differ,
            "mask_cap": cap, "matches": int(n), "cpu_matches": int(ref_n), "ir": ir,
            "nfmr": nf, "cpu_ir": ref_ir, "cpu_nfmr": ref_nf}


def run_story4d(repo, kernels, launches, gen):
    """Phase 20: the 4DMatch synthetic training story's committed trained
    weights (STORY4D_PARAMS) on the card. 20a: both bf16 instances at its
    shapes (run_story_kernels on its pool batch 0). 20b: the tester protocol's
    eval of the 32 test pairs (the stochastic DDIM from the tool's fixed
    draws, the thr-mutual mask at 0.55, IR and NFMR), launches counted, IR
    and NFMR within METRIC_4D_ABS_TOL of metrics.json's. 20c: test pair 0 at
    batch 1, card against CPU, in bf16 and in f32 (the same weights, TF32 off)
    from the first draw whose step conditions and cut gaps clear
    (story4d_draw), at the protocol's threshold 0.55 (story4d_pair0_check).
    Returns the entries for the JSON line's ``story_4d`` keys."""
    import torch

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16

    tool = story_tool(repo, "train_synthetic_4d_port")
    path = os.path.join(repo, STORY4D_PARAMS)
    with open(os.path.join(os.path.dirname(path), "metrics.json")) as f:
        recorded = json.load(f)

    # ---- 20a. the bf16 kernels at the story's shapes ----
    kp, at = run_story_kernels(tool, gen, tool.deformable_batch(STORY4D_BATCH, 0)[0],
                               tag="4D story")

    # ---- 20b. the trained weights' eval of the test split ----
    model = tool.load_params(tool.build_model("cuda"), path)
    heldout = tool.split_batches(tool.TEST_SEED, tool.TEST_BATCHES, STORY4D_BATCH, "cuda")
    split_metrics = tool.make_split_metrics(model)
    split_metrics(heldout[:1])                                            # warm-up
    counted = (kpconv_cuda_bf16, masked_attention_cuda_bf16, kpconv_cuda, masked_attention_cuda)
    for fn in counted:
        fn.launches = 0
    (ir, nf), seconds = wall(lambda: split_metrics(heldout))
    n_kp, n_at, n_f32 = kpconv_cuda_bf16.launches, masked_attention_cuda_bf16.launches, \
        kpconv_cuda.launches + masked_attention_cuda.launches
    steps = model.cfg.sample_steps
    per_step = attention_calls(tool.N_POINTS, tool.N_POINTS, model.cfg.denoising_layer_types)
    if n_kp != 11 * len(heldout) or n_at != per_step * steps * len(heldout) or n_f32:
        raise AssertionError(f"story 4D eval: {n_kp} bf16 KPConv, {n_at} bf16 attention, "
                             f"{n_f32} f32 launches")
    launches["kpconv_bf16_story4d"] += n_kp
    launches["masked_attention_bf16_story4d"] += n_at
    pairs = len(heldout) * STORY4D_BATCH
    want = {"IR": recorded["heldout_ir_after"], "NFMR": recorded["heldout_nfmr_after"]}
    log(f"story 4D, trained weights ({STORY4D_PARAMS}, selected step "
        f"{recorded['selected_step']}): {pairs} test pairs through the stochastic DDIM "
        f"({steps} steps, gate 40) at threshold {tool.MATCH_THR} in {seconds:.3f} s "
        f"({pairs / seconds:.3f} pairs/s): IR {ir:.5f} (metrics.json {want['IR']:.5f}), NFMR "
        f"{nf:.5f} (metrics.json {want['NFMR']:.5f}), limit {METRIC_4D_ABS_TOL}; launches bf16 "
        f"kpconv {n_kp} attention {n_at}, f32 0")
    if not (abs(ir - want["IR"]) <= METRIC_4D_ABS_TOL
            and abs(nf - want["NFMR"]) <= METRIC_4D_ABS_TOL):
        raise AssertionError(f"story 4D eval IR {ir} NFMR {nf} against metrics.json's {want}")

    # ---- 20c. test pair 0, card against CPU, bf16 and f32, at threshold 0.55 ----
    one, metric = tool.deformable_batch(1, tool.TEST_SEED)
    seed, x_init, noise, card_gaps, clear = story4d_draw(model, one)
    log(f"story 4D pair 0: draw seed {seed}; top-k cut gaps per DDIM step on the card "
        f"{min(card_gaps):.3e} to {max(card_gaps):.3e} (limit {CUT_GAP_MIN:.0e}), step "
        f"conditions at least {clear:.3f} from the gate (limit {STORY4D_GATE_CLEAR})")
    pair0, confs = {"draw_seed": seed, "cut_gap_min": min(card_gaps), "gate_clear": clear}, {}
    for name, dtype, precision in (("bf16", "bfloat16", None), ("f32", None, "highest")):
        card = tool.load_params(tool.build_model("cuda", dtype, precision), path)
        cpu = tool.load_params(tool.build_model("cpu", dtype, precision), path)
        with torch.no_grad():
            got = card.ddim_sample(one.to("cuda"), x_init.cuda(), ddim_noise=noise.cuda())
            t0 = time.perf_counter()
            ref = cpu.ddim_sample(one, x_init, ddim_noise=noise)
            cpu_s = time.perf_counter() - t0
        pair0[name] = story4d_pair0_check(name, tool, got, ref, one, metric,
                                          STORY4D_LIMITS[name], cpu_s)
        pair0[name]["cpu_gate_clear"] = float(
            (ref["step_condition"] - model.cfg.procrustes.max_condition_num).abs().min())
        confs[name] = got["conf_matrix_pred"].cpu()
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    pair0["bf16_vs_f32_rel"] = float((confs["bf16"] - confs["f32"]).abs()[valid].max()) / \
        pair0["f32"]["top"]
    log(f"story 4D pair 0 on the card, bf16 vs f32: {pair0['bf16_vs_f32_rel']:.3e} of the "
        f"largest confidence (limits: bf16 {STORY4D_LIMITS['bf16']['conf']}, f32 "
        f"{STORY4D_LIMITS['f32']['conf']})")
    at["trained"] = {"test_pairs": pairs, "ir": ir, "nfmr": nf, "seconds": seconds,
                     "recorded": want, "pair0": pair0}
    return kp, at


# ---------------------------------------------------------------- 22. model variants


def variant_cfg(cfg, name):
    """``cfg`` (a preset) as phase 22's variant ``name`` (``VARIANTS``)."""
    v = VARIANTS[name]
    arch = tuple(b.replace("resnetb", "resnetb_deformable") if i in v["deformable"] else b
                 for i, b in enumerate(cfg.kpfcn.architecture))
    matching = dataclasses.replace(cfg.coarse_matching, **v["matching"])
    transformer = dataclasses.replace(cfg.coarse_transformer, feature_matching=matching,
                                      **v["transformer"])
    kpfcn = dataclasses.replace(cfg.kpfcn, architecture=arch, **v["kpfcn"])
    return dataclasses.replace(cfg, kpfcn=kpfcn, coarse_transformer=transformer,
                               coarse_matching=matching)


def reset_kpconv_counts():
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16

    for wrapper in (kpconv_cuda, kpconv_cuda_bf16):
        wrapper.launches = 0
        wrapper.mode_launches = {}
        wrapper.point_launches = {}
        wrapper.route_launches = {}


def run_mode_kernels(calls, gen):
    """Phase 22a: each new KPConv mode instance, f32 and bf16, against its plain
    version at a 3DMatch encode's 11 layers (timed, with its bound) and at the
    tilings' edges, and its autograd Function's gradients against plain
    autograd. Returns the two JSON entries (f32, bf16) with one record a mode."""
    entries = []
    for bf16 in (False, True):
        modes = {}
        for mode in VARIANT_MODES:
            key = "/".join(mode)
            tag = f"{' bf16' if bf16 else ''} {key}"
            entry, shapes = check_kpconv(calls, 11, "one encode (11 calls)", tag=tag, bf16=bf16,
                                         modes=mode)
            grad_err, back_ms = kpconv_gradients(shapes, gen, bf16=bf16, modes=mode)
            edges = kpconv_edge_cases(gen, bf16, mode)
            modes[key] = {k: entry[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "excused_rows", "shapes")}
            modes[key].update(backward_ms=back_ms, backward_max_rel_err=grad_err,
                              edges_max_rel_err=max(c["max_abs_err"] / c["max_abs_plain"]
                                                    for c in edges),
                              edges_excused_rows=sum(c["excused_rows"] for c in edges),
                              launches=0)
            log(f"kpconv{tag}: {entry['ms']:.4f} ms an encode (plain {entry['plain_ms']:.4f}, "
                f"bound {entry['bound_ms']:.4f} {entry['bound_by']}), backward "
                f"{back_ms:.2f} ms")
        top = max(modes.values(), key=lambda m: m["bound_ms"])
        entries.append({
            "name": "kpconv_bf16_modes" if bf16 else "kpconv_modes", "route": "cuda",
            "source": f"diffreg_tpu_torch/csrc/{'kpconv_bf16' if bf16 else 'kpconv'}.cu",
            "replaces": "diffreg_tpu/ops/pallas/kpconv_kernel.py:38", "launches": 0,
            "max_abs_err": max(m["max_abs_err"] for m in modes.values()),
            "ms": sum(m["ms"] for m in modes.values()),
            "plain_ms": sum(m["plain_ms"] for m in modes.values()),
            "bound_ms": sum(m["bound_ms"] for m in modes.values()),
            "bound_by": top["bound_by"], "library_ms": None,
            "per": "one 3DMatch encode (11 calls) in each of the five modes",
            "backward_ms": sum(m["backward_ms"] for m in modes.values()), "modes": modes})
    return entries


def kernel_closest_choice(q, s, inds, kp, cin, cout):
    """The Hopper kernel's "closest" choice of kernel point [B, Nq, K] (-1 at a
    sentinel) for every neighbour of one KPConv call, read from the kernel:
    each neighbour becomes a query of its own (K = 1) over features of ones
    of the call's Cin, with weights that send kernel point p to output p (1 /
    Cin from each channel, so that a neighbour's output row is exactly one-hot),
    under constant influence (the choice does not depend on the influence), so
    on the kernel path of the call's Cin and Cout (at least P)."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    b, nq, k = inds.shape
    p = kp.shape[0]
    cout = max(cout, p)
    q1 = q[:, :, None, :].expand(b, nq, k, 3).reshape(b, nq * k, 3).contiguous()
    x = torch.ones(b, s.shape[1], cin, device=s.device)
    w = torch.zeros(p, cin, cout, device=s.device)
    w[torch.arange(p), :, torch.arange(p)] = 1.0 / cin
    out = kpconv_cuda(q1, s, inds.reshape(b, nq * k, 1).contiguous(), x, kp, w, 1.0,
                      "constant", "closest").reshape(b, nq, k, cout).cpu()
    valid = (inds < s.shape[1]).cpu()
    one_hot = ((out == 0) | (out == 1)).all(dim=-1) & (out[..., :p].sum(dim=-1) == 1)
    if not bool(one_hot[valid].all()):
        raise AssertionError("closest: the kernel's choice is not one kernel point")
    return torch.where(valid, out[..., :p].argmax(dim=-1), -1)


def closest_flips(model, one):
    """Pair 0's encode under "closest": each layer's choice of kernel point
    for every real neighbour, the Hopper kernel's (``kernel_closest_choice``
    on the card, from the positions the layer got there) against the plain
    version's on the CPU from the same positions. Returns (flips, near-ties,
    real neighbours); a flip that is no near-tie raises."""
    import torch

    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.kpconv import _gather

    calls = kpconv_layer_calls(model, lambda: model.encode(one.to("cuda")), KPConv)
    flips = ties = real = 0
    for q, s, inds, x, kp, w, _ in calls:
        got = kernel_closest_choice(q, s, inds, kp, x.shape[2], w.shape[2])
        qc, sc, ic, kc = (t.cpu() for t in (q, s, inds, kp))
        n, _ = _gather(qc, sc, ic, torch.zeros(sc.shape[0], sc.shape[1], 1))
        sq_d = ((n * n).sum(-1, keepdim=True) + (kc * kc).sum(-1)
                - 2.0 * torch.einsum("bnkc,pc->bnkp", n, kc)).clamp_min(0.0)
        valid = ic < sc.shape[1]
        flipped = (got != sq_d.argmin(dim=-1)) & valid
        tie_rows, n_ties = closest_near_ties(qc, sc, ic, kc)
        if bool((flipped.any(dim=-1) & ~tie_rows).any()):
            raise AssertionError("closest: the kernel on the card and the plain version on "
                                 "the CPU pick another kernel point where no near-tie is")
        flips, ties, real = flips + int(flipped.sum()), ties + n_ties, real + int(valid.sum())
    return flips, ties, real


def range_flips(card_model, cpu_model, one):
    """Card against CPU on pair 0's encode in the deformable convs: the in-range
    cut of every real neighbour (its nearest deformed kernel point within the
    extent), each device from its own deformed kernel points. Returns (flips,
    real neighbours); a flip farther than RANGE_CUT_REL of extent^2 from the
    cut, or more than RANGE_FLIP_SHARE of them, raises."""
    import torch

    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.kpconv import _gather

    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args[:3])))
             for m in card_model.modules() if isinstance(m, KPConv) and m.offset_conv is not None]
    cpu_convs = [m for m in cpu_model.modules() if isinstance(m, KPConv)
                 and m.offset_conv is not None]
    with torch.no_grad():
        card_model.encode(one.to("cuda"))
        cpu_model.encode(one)
    for h in hooks:
        h.remove()
    flips = real = 0
    for (mod, (q, s, inds)), cpu_mod in zip(seen, cpu_convs):
        sides = []
        for dev, kp in (("cuda", mod.deform_aux["deformed_kp"]),
                        ("cpu", cpu_mod.deform_aux["deformed_kp"])):
            qd, sd, idd = (t.to(dev) for t in (q, s, inds))
            n, _ = _gather(qd, sd, idd, torch.zeros(sd.shape[0], sd.shape[1], 1, device=dev))
            sq_d = ((n * n).sum(-1, keepdim=True) + (kp * kp).sum(-1)[:, :, None, :]
                    - 2.0 * torch.einsum("bnkc,bnpc->bnkp", n, kp)).clamp_min(0.0)
            sides.append(sq_d.amin(dim=-1).cpu())
        cut = mod.extent ** 2
        valid = (inds < s.shape[1]).cpu()
        flipped = ((sides[0] < cut) != (sides[1] < cut)) & valid
        near = (sides[1] - cut).abs() <= RANGE_CUT_REL * cut
        if bool((flipped & ~near).any()):
            raise AssertionError("deformable in-range cut: a neighbour flips away from the cut")
        flips, real = flips + int(flipped.sum()), real + int(valid.sum())
    if flips > RANGE_FLIP_SHARE * real:
        raise AssertionError(f"deformable in-range cut: {flips} of {real} neighbours flip")
    return flips, real


def pair0_masks(got, ref, one, limit):
    """Pair 0's top-1 union masks, card (``got``) against CPU (``ref``): the
    entries that differ, those outside a near-tie (a row's or column's best two
    CPU confidences within twice ``limit``), the cap (1% of the CPU mask plus
    2) and the share of real source rows free of a near-tie."""
    import torch

    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    differ = (got["corr_mask"][:1].cpu() != ref["corr_mask"]) & valid
    c = torch.where(valid, ref["conf_matrix_pred"], torch.full_like(ref["conf_matrix_pred"],
                                                                    -1.0))
    top_r, top_c = c.topk(2, dim=2).values, c.topk(2, dim=1).values
    row_tie = (top_r[..., 0] - top_r[..., 1]) <= 2 * limit
    col_tie = (top_c[:, 0] - top_c[:, 1]) <= 2 * limit
    return {"differ": int(differ.sum()),
            "unexplained": int((differ & ~(row_tie[:, :, None] | col_tie[:, None, :])).sum()),
            "cap": MASK_DIFFER_SHARE * max(int(ref["corr_mask"].sum()), 1) + 2,
            "tie_free": float((~row_tie[0] & one.src_mask[0]).sum())
            / max(int(one.src_mask[0].sum()), 1)}


def variant_pair0(name, got, ref, one, tag, backbone=False, pose=False):
    """Pair 0 of a variant, card (``got``, its first pair) against CPU
    (``ref``): the DDIM's confidences (its mask and pose printed), or with
    ``backbone`` backbone_forward's confidences, mask and pose
    (VARIANT_CONF_REL_TOL's comment); ``pose``: the pose held at POSE_ABS_TOL
    too (the card having kept the CPU's top-k choices). Returns the record."""
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    conf = ref["conf_matrix_pred"]
    top = float(conf[valid].max())
    rel_tol = (VARIANT_BACKBONE_REL_TOL if backbone else VARIANT_CONF_REL_TOL)[name]
    conf_rel = float((got["conf_matrix_pred"][:1].cpu() - conf).abs()[valid].max()) / top
    pose_err = max(float((got[k][:1].cpu() - ref[k]).abs().max())
                   for k in ("rotation_pred", "translation_pred"))
    gap = cut_gap(conf, one.src_mask, one.tgt_mask)
    k = int(max(one.src_mask.sum(), one.tgt_mask.sum()))
    kept = [set(c[0].flatten().topk(k).indices.tolist())
            for c in (got["conf_matrix_pred"][:1].cpu(), conf)]
    cut_flips = len(kept[0] ^ kept[1]) // 2
    masks = pair0_masks(got, ref, one, rel_tol * top)
    held = f" (limit {POSE_ABS_TOL:.0e})" if backbone or pose else " (printed)"
    cap = f", cap {masks['cap']:.0f}" if backbone else ""
    log(f"card vs CPU {tag}: conf {conf_rel:.3e} of the largest ({top:.3e}; limit "
        f"{rel_tol:.0e}); top-k cut gap {gap:.3e}, {cut_flips} of its {k} entries differ, "
        f"pose {pose_err:.3e}{held}; {masks['differ']} "
        f"mask entries differ ({masks['unexplained']} outside a near-tie{cap}), real rows "
        f"free of a near-tie {masks['tie_free']:.4f}")
    if not conf_rel <= rel_tol:
        raise AssertionError(f"{tag}: confidences differ by {conf_rel} of the largest")
    if pose and not pose_err <= POSE_ABS_TOL:
        raise AssertionError(f"{tag}: pose differs by {pose_err}")
    if backbone:
        if cut_flips:
            raise AssertionError(f"{tag}: soft Procrustes keeps {cut_flips} other entries")
        if not pose_err <= POSE_ABS_TOL:
            raise AssertionError(f"{tag}: pose differs by {pose_err}")
        if masks["unexplained"] or masks["differ"] > masks["cap"] \
                or masks["tie_free"] < TIE_FREE_ROWS_MIN:
            raise AssertionError(f"{tag}: mask {masks}")
    return {"conf_rel": conf_rel, "pose": pose_err, "cut_gap": gap, "cut_flips": cut_flips,
            **masks}


@contextlib.contextmanager
def topk_choices(record=None, replay=None, cut=None):
    """Soft Procrustes' top-k choices, call by call, within the block. With
    ``record`` (a list) each call's (indices, values) are appended, on the CPU.
    With ``replay`` (such a list, from the same calls) each call keeps the
    recorded indices, weighted by its own confidences there, instead of its
    own top-k: the discrete choice made as the recording device made it.
    Each of those calls compares the first ``cut`` of its own choice with the
    recorded one; the yielded dict counts the calls, the entries that differ,
    and those whose recorded confidence lies farther than TOPK_CUT_REL of the
    recorded cut's value from it (or outside the recorded top-k)."""
    from diffreg_tpu_torch.geometry import procrustes

    original = procrustes.stable_top_k
    seen = {"calls": 0, "differ": 0, "far": 0}

    def recording(x, k):
        w, idx = original(x, k)
        record.append((idx.cpu(), w.detach().cpu()))
        return w, idx

    def replaying(x, k):
        idx_ref, w_ref = replay[seen["calls"]]
        seen["calls"] += 1
        own = original(x, k)[1].cpu()
        for row in range(idx_ref.shape[0]):
            kept = idx_ref[row].tolist()
            differ = set(own[row, :cut].tolist()) ^ set(kept[:cut])
            where = {j: i for i, j in enumerate(kept)}
            c = float(w_ref[row, cut - 1])
            seen["differ"] += len(differ)
            seen["far"] += sum(1 for j in differ if j not in where or abs(
                float(w_ref[row, where[j]]) - c) > TOPK_CUT_REL * c)
        idx = idx_ref.to(x.device)
        return x.gather(1, idx), idx

    procrustes.stable_top_k = recording if record is not None else replaying
    try:
        yield seen
    finally:
        procrustes.stable_top_k = original
    if replay is not None and seen["calls"] != len(replay):
        raise AssertionError(f"top-k choices: {seen['calls']} calls replayed {len(replay)}")


def topk_share(seen, cut):
    return seen["differ"] / max(seen["calls"] * cut, 1)


def check_replayed(seen, cut, tag):
    """Raise unless every top-k entry that the replaying device would have
    chosen otherwise lies within TOPK_CUT_REL of the cut, at most
    TOPK_DIFFER_SHARE of the entries kept over the calls."""
    if seen["far"] or topk_share(seen, cut) > TOPK_DIFFER_SHARE:
        raise AssertionError(f"{tag}: top-k choices {seen} of {cut} kept a call")


def variant_gate_start(model, one):
    """Pair 0's DDIM draws for the gated DDIM of ``model`` (on the card): the
    first of the CPU generator's seeds 1, 2, ... whose start [1, S, T] keeps,
    in the card's DDIM, every step's Procrustes condition at least
    VARIANT_GATE_CLEAR from the gate. Returns (seed, x_init, u, least
    distance from the gate)."""
    import torch

    from diffreg_tpu_torch.eval.register import register

    gate = model.cfg.procrustes.max_condition_num
    for seed in range(1, VARIANT_START_TRIES + 1):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((1, one.src_mask.shape[1], one.tgt_mask.shape[1]), generator=g)
        u = torch.rand(1, HYPOTHESES, 3, generator=g)
        out = register(model, one.to("cuda"), x.cuda(), u.cuda())
        clear = float((out["step_condition"] - gate).abs().min())
        if clear >= VARIANT_GATE_CLEAR:
            return seed, x, u, clear
    raise AssertionError(f"variant pair 0 at gate {gate:g}: no start of seeds 1-"
                         f"{VARIANT_START_TRIES} keeps its conditions {VARIANT_GATE_CLEAR} from "
                         "the gate")


def deformable_times(model, batch):
    """Each deformable KPConv of ``model``'s encode of ``batch``, timed on the
    card: the whole ``kpconv_deformable`` call and its offset conv (the Hopper
    kernel) alone; the deformed conv (plain PyTorch) is the difference. Returns
    one record a block."""
    import torch

    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.kpconv import kpconv_batched

    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args)))
             for m in model.modules() if isinstance(m, KPConv) and m.offset_conv is not None]
    with torch.no_grad():
        model.encode(batch)
    for h in hooks:
        h.remove()
    times = []
    with torch.no_grad():
        for mod, args in seen:
            q, s, inds, x = args[:4]
            whole = time_cuda(lambda: mod(*args), 10)
            offset = time_cuda(lambda: kpconv_batched(
                q, s, inds, x, mod.offset_conv.kernel_points, mod.offset_conv.weights,
                mod.extent, mod.compute_dtype, *mod.modes), 10)
            times.append({"nq": q.shape[1], "k": inds.shape[2], "cin": x.shape[2],
                          "cout": mod.weights.shape[2], "ms": whole, "offset_conv_ms": offset,
                          "deformed_conv_ms": whole - offset})
            log(f"deformable KPConv {q.shape[1]}/K{inds.shape[2]}/{x.shape[2]}->"
                f"{mod.weights.shape[2]}: {whole:.4f} ms, of which the offset conv (kernel) "
                f"{offset:.4f} ms and the deformed conv (plain PyTorch) {whole - offset:.4f} ms")
    return times


def run_variant(name, batch, one, x_init, u, spec, launches):
    """Phase 22b-c: variant ``name`` at full width on the 4 pairs: the DDIM path
    (``register``) at gate 0 and 40 with its launches (every KPConv in the
    variant's mode), deformable blocks' times, pair 0 card against CPU (the
    DDIM at gate 0, the DDIM at gate 40 from a start clear of ties
    (``variant_gate_start``) and backbone_forward), the discrete choices
    card against CPU (closest's kernel point, the deformable in-range cut),
    the fitting regularizer card against CPU, one train step at gate 200 card
    against CPU at phase 8's limits, and one bf16 DDIM on the 4 pairs (the
    bf16 instance in the same mode). Returns the variant's record."""
    import torch

    from diffreg_tpu_torch.engine.loss_library import p2p_fitting_regularizer
    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import (preset_3dmatch, with_condition_gate,
                                                  with_fast_path)
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16

    v = VARIANTS[name]
    mode = "/".join(v["modes"])
    # a deformable block launches its offset conv; its deformed conv is plain
    n_kp = 11
    cfg = variant_cfg(preset_3dmatch(sample_steps=STEPS), name)
    per_run = STEPS * attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    record = {"modes": mode, "kpconv_launches_per_run": n_kp, "kpconv_launches": 0,
              "kpconv_bf16_launches": 0}
    results, models = {}, {}
    for gate in GATES:
        model = models[gate] = DiffusionMatchingModel(with_condition_gate(cfg, gate),
                                                      device="cuda", seed=0)
        register(model, batch, x_init, u)                      # warm-up
        reset_kpconv_counts()
        masked_attention_cuda.launches = 0
        out, seconds = wall(lambda: register(model, batch, x_init, u))
        counts = dict(kpconv_cuda.mode_launches)
        n_at = masked_attention_cuda.launches
        if counts != {mode: n_kp} or kpconv_cuda_bf16.launches or n_at != per_run:
            raise AssertionError(f"variant {name} gate {gate}: KPConv launches {counts} (want "
                                 f"{{{mode!r}: {n_kp}}}), attention {n_at} (want {per_run})")
        check_outputs(out, f"variant {name} gate {gate}")
        record["kpconv_launches"] += n_kp
        launches["masked_attention"] += n_at
        results[gate] = out
        record[f"pairs_per_s_gate_{gate:g}"] = BATCH_PAIRS / seconds
        log(f"variant {name} gate {gate}: {BATCH_PAIRS} pairs in {seconds:.4f} s = "
            f"{BATCH_PAIRS / seconds:.3f} pairs/s; launches kpconv {counts} attention {n_at}")

    if v["deformable"]:
        record["deformable_ms"] = deformable_times(model, batch)

    # pair 0 on the CPU (the DDIM at gate 0, backbone_forward), the discrete
    # choices and the regularizer
    model = models[0.0]
    cpu_model = DiffusionMatchingModel(with_condition_gate(cfg, 0.0), device="cpu", seed=0)
    t0 = time.perf_counter()
    ref = register(cpu_model, one, x_init[:1], u[:1], device="cpu")
    cpu_s = time.perf_counter() - t0
    check_outputs(ref, f"variant {name} CPU")
    record["pair0"] = variant_pair0(name, results[0.0], ref, one,
                                    f"variant {name} DDIM gate 0 (CPU {cpu_s:.1f} s)")
    with torch.no_grad():
        got = model.backbone_forward(one.to("cuda"))
        ref = cpu_model.backbone_forward(one)
    record["pair0_backbone"] = variant_pair0(name, got, ref, one,
                                             f"variant {name} backbone_forward", backbone=True)
    # pair 0 at gate 40 from a start whose conditions lie clear of the gate,
    # the card keeping the CPU's top-k choices in the gated warps and the pose
    seed, x0, u0, clear = variant_gate_start(models[40.0], one)
    cpu_gated = DiffusionMatchingModel(with_condition_gate(cfg, 40.0), device="cpu", seed=0)
    choices, cut = [], int(max(one.src_mask.sum(), one.tgt_mask.sum()))
    t0 = time.perf_counter()
    with topk_choices(record=choices):
        ref = register(cpu_gated, one, x0, u0, device="cpu")
    cpu_s = time.perf_counter() - t0
    del cpu_gated
    with topk_choices(replay=choices, cut=cut) as seen:
        got = register(models[40.0], one.to("cuda"), x0.cuda(), u0.cuda())
    check_outputs(ref, f"variant {name} CPU gate 40")
    tag = f"variant {name} DDIM gate 40"
    record["pair0_gate_40"] = variant_pair0(
        name, got, ref, one, f"{tag} (start seed {seed}, conditions {clear:.3f} from the gate, "
        f"the CPU's top-k choices in {seen['calls']} Procrustes calls: {seen['differ']} entries "
        f"of the card's own differ, a share {topk_share(seen, cut):.4f} of the kept (cap "
        f"{TOPK_DIFFER_SHARE}), {seen['far']} farther than {TOPK_CUT_REL:.0e} of the cut; "
        f"CPU {cpu_s:.1f} s)", pose=True)
    check_replayed(seen, cut, tag)
    record["pair0_gate_40"].update(start_seed=seed, gate_distance=clear,
                                   topk_differ=seen["differ"], topk_calls=seen["calls"])
    if v["deformable"]:
        flips, real = range_flips(model, cpu_model, one)
        reg = [float(p2p_fitting_regularizer(m).cpu()) for m in (model, cpu_model)]
        reg_rel = abs(reg[0] - reg[1]) / abs(reg[1])
        log(f"variant {name} pair 0: deformable in-range cut flips card vs CPU {flips} of "
            f"{real} real neighbours (each within {RANGE_CUT_REL:.0e} of extent^2 of the cut); "
            f"p2p_fitting_regularizer card {reg[0]:.6e} CPU {reg[1]:.6e} (rel {reg_rel:.3e}, "
            f"limit {VARIANT_REG_REL_TOL:.0e})")
        if not reg_rel <= VARIANT_REG_REL_TOL:
            raise AssertionError(f"variant {name}: the regularizer differs by {reg_rel}")
        record.update(range_flips=flips, real_neighbours=real, regularizer_rel=reg_rel)
    if v["modes"][1] == "closest":
        flips, ties, real = closest_flips(model, one)
        log(f"variant {name} pair 0: closest's kernel point, the kernel on the card against the "
            f"plain version on the CPU, flips {flips} of {real} "
            f"real neighbours ({ties} near-ties within {CLOSEST_TIE_REL:.0e})")
        record.update(closest_flips=flips, closest_near_ties=ties, real_neighbours=real)
    del cpu_model, model, models, results

    # one train step at gate 200, card against CPU
    record["train_step"] = train_step_card_vs_cpu(
        variant_cfg(preset_3dmatch(train=True), name), one, tag=f" variant {name}",
        align_topk=VARIANT_ALIGN_TOPK[name])

    # the bf16 instance in the variant's mode: one DDIM at gate 0
    model = DiffusionMatchingModel(with_fast_path(with_condition_gate(cfg, 0.0)), device="cuda",
                                   seed=0)
    register(model, batch, x_init, u)                          # warm-up
    reset_kpconv_counts()
    masked_attention_cuda_bf16.launches = 0
    out, seconds = wall(lambda: register(model, batch, x_init, u))
    counts = dict(kpconv_cuda_bf16.mode_launches)
    if counts != {mode: n_kp} or kpconv_cuda.launches:
        raise AssertionError(f"variant {name} bf16: KPConv launches {counts}")
    check_outputs(out, f"variant {name} bf16")
    record["kpconv_bf16_launches"] += n_kp
    launches["masked_attention_bf16"] += masked_attention_cuda_bf16.launches
    record["pairs_per_s_bf16_gate_0"] = BATCH_PAIRS / seconds
    log(f"variant {name} bf16 gate 0: {BATCH_PAIRS / seconds:.3f} pairs/s; launches "
        f"kpconv_bf16 {counts}")
    return record


def run_cli_variant(repo, launches):
    """Phase 22d: ``diffreg_tpu_torch.main`` on configs/test/3dmatch.yaml with
    variant A's keys (a YAML in a temporary directory), test mode, --demo."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.models.presets import KPFCN_ARCHITECTURE
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import load_yaml

    raw = load_yaml(os.path.join(repo, "configs", "test", "3dmatch.yaml"))
    raw.update(exp_dir="variant-a", modulated=True, architecture=[
        b.replace("resnetb", "resnetb_deformable") if i in VARIANTS["A"]["deformable"] else b
        for i, b in enumerate(KPFCN_ARCHITECTURE)])
    raw["kpfcn_config"].update(KP_influence="gaussian", use_batch_norm=False)
    raw["coarse_transformer"]["pe_type"] = "sinusoidal"
    raw["coarse_matching"]["match_type"] = "dual_softmax"
    _, demo_spec, _ = synthetic_batch(batch_size=1, n_points=768, seed=0)
    want_at = STEPS * attention_calls(demo_spec.n_src, demo_spec.n_tgt, ("self", "cross") * 3)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "variant_a.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        os.chdir(tmp)
        try:
            reset_kpconv_counts()
            masked_attention_cuda.launches = 0
            summary, seconds = wall(lambda: cli(["--config", path, "--demo", "--num-pairs",
                                                 str(BATCH_PAIRS), "--batch-size",
                                                 str(BATCH_PAIRS)]))
        finally:
            os.chdir(cwd)
    counts, n_at = dict(kpconv_cuda.mode_launches), masked_attention_cuda.launches
    if counts != {"gaussian/sum": 11} or n_at != want_at:
        raise AssertionError(f"main variant A: KPConv launches {counts}, attention {n_at}")
    if not all(math.isfinite(summary[k]) for k in ("IR", "FMR", "RR")):
        raise AssertionError(f"main variant A: summary {summary}")
    launches["masked_attention"] += n_at
    log(f"main variant A (3dmatch.yaml with the variant's keys, --demo), {BATCH_PAIRS} pairs: "
        f"{seconds:.2f} s, launches kpconv {counts} attention {n_at}; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in summary.items()))
    return {"seconds": seconds, "kpconv_launches": 11,
            **{k: summary[k] for k in ("IR", "FMR", "RR")}}


def run_variants(repo, batch, batch_cpu, spec, x_init, u, launches, gen):
    """Phase 22: the KPConv mode instances (a), variants A (b) and B (c) at full
    width, the CLI on a variant YAML (d). Returns the two JSON entries."""
    import torch

    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_3dmatch
    from diffreg_tpu_torch.nn.kpfcn import KPConv

    t0 = time.perf_counter()
    base = DiffusionMatchingModel(preset_3dmatch(sample_steps=STEPS), device="cuda", seed=0)
    calls = kpconv_layer_calls(base, lambda: base.encode(batch), KPConv)
    entries = run_mode_kernels(calls, gen)
    del calls, base
    torch.cuda.empty_cache()
    one = batch_cpu.select(slice(0, 1))
    variants = {name: run_variant(name, batch, one, x_init, u, spec, launches)
                for name in VARIANTS}
    variants["cli"] = run_cli_variant(repo, launches)
    for entry, key in zip(entries, ("kpconv_launches", "kpconv_bf16_launches")):
        for name in VARIANTS:
            entry["modes"]["/".join(VARIANTS[name]["modes"])]["launches"] += variants[name][key]
        entry["launches"] = sum(m["launches"] for m in entry["modes"].values())
    entries[0]["modes"]["gaussian/sum"]["launches"] += variants["cli"]["kpconv_launches"]
    entries[0]["launches"] += variants["cli"]["kpconv_launches"]
    entries[0]["variants"] = variants
    log(f"phase 22 (model variants): {time.perf_counter() - t0:.1f} s")
    return entries


def shape_calls(calls, n_points, gen):
    """``calls`` (KPConv inputs (q, s, inds, x, kernel points, weights,
    extent)) at ``n_points`` kernel points: each layer's disposition rebuilt
    at that count on the layer's radius, weights drawn as the model draws
    them; the calls as they are at their own count."""
    import torch

    from diffreg_tpu_torch.ops.kernel_points import unit_kernel_points

    out = []
    for q, s, inds, x, kp, w, extent in calls:
        if kp.shape[0] != n_points:
            unit = torch.from_numpy(unit_kernel_points(kp.shape[0]))
            radius = float(kp.cpu().norm(dim=1).max() / unit.norm(dim=1).max())
            kp = (torch.from_numpy(unit_kernel_points(n_points)) * radius).to(kp.device)
            limit = math.sqrt(3.0 * (2.0 / n_points) / (n_points * x.shape[2]))
            w = ((torch.rand(n_points, x.shape[2], w.shape[2], generator=gen) * 2 - 1)
                 * limit).to(w.device)
        out.append((q, s, inds, x, kp.contiguous(), w.contiguous(), extent))
    return out


def level0_calls_2d3d(gen):
    """KPConv inputs at the 2D-3D point backbone's level-0 shapes (4 pairs of
    39,168 points, K = 64 nearest within the radius, the rest the sentinel;
    1 -> 64 and 32 -> 32, the layers the any-shape kernel takes), at 15
    kernel points on rgbdv2.yaml's first radius (0.0625, sigma 0.05)."""
    import torch

    from diffreg_tpu_torch.ops.kernel_points import load_kernel_points

    b, n, k = 4, 39168, 64
    pts = (torch.rand(b, n, 3, generator=gen) * 1.2).cuda()
    inds = torch.empty(b, n, k, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for i in range(b):
            for c0 in range(0, n, 4096):
                d, j = torch.cdist(pts[i, c0:c0 + 4096], pts[i]).topk(k, largest=False)
                inds[i, c0:c0 + 4096] = torch.where(d < 0.1, j, n).int()
    kp = torch.from_numpy(load_kernel_points(0.0625, 15, 3, "center")).cuda()
    calls = []
    for cin, cout in ((1, 64), (32, 32)):
        x = torch.rand(b, n, cin, generator=gen).cuda() if cin == 1 else \
            torch.randn(b, n, cin, generator=gen).cuda()
        w = (torch.randn(15, cin, cout, generator=gen) * 0.05).cuda()
        calls.append((pts, pts, inds, x, kp, w, 0.05))
    return calls


def shape_range_kpconv(calls, gen):
    """Phase 23a: both KPConv kernels at every P of SHAPE_POINTS against their
    plain versions (check_kpconv: the limits of phase 1, timed, with the
    bound): at a 3DMatch encode's 11 layers (configuration C's, on the
    activations its encoder feeds them; ``shape_calls`` at the other counts)
    and at the 2D-3D level-0 shapes; linear/sum at every P, gaussian/sum and
    linear/closest at SHAPE_MODE_POINTS; then the gradients through both
    autograd Functions at P = 24 (kpconv_gradients). Returns {"f32" | "bf16":
    {P or "P/mode": record}}."""
    level0 = level0_calls_2d3d(gen)
    records = {"f32": {}, "bf16": {}}
    for n_points in SHAPE_POINTS:
        encode = shape_calls(calls, n_points, gen)
        narrow = shape_calls(level0, n_points, gen)
        cases = [("linear", "sum")] + ([("gaussian", "sum"), ("linear", "closest")]
                                       if n_points in SHAPE_MODE_POINTS else [])
        for bf16 in (False, True):
            for modes in cases:
                key = str(n_points) if modes == ("linear", "sum") else \
                    f"{n_points}/{'/'.join(modes)}"
                tag = f" (P {n_points}{'' if key.isdigit() else ', ' + '/'.join(modes)}" \
                    f"{', bf16' if bf16 else ''})"
                entry, shapes = check_kpconv(encode, 11, "one encode (11 calls)", tag, bf16,
                                             modes, flip_excuse=True)
                level, _ = check_kpconv(narrow, 2, "2D-3D level 0 (2 calls)", tag + " 2D-3D",
                                        bf16, modes, flip_excuse=True)
                rec = {k: entry[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "shapes", "excused_rows")}
                rec["level0_2d3d"] = {k: level[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "bound_by", "shapes")}
                if key == "24":
                    worst, total = kpconv_gradients(shapes, gen, bf16, modes)
                    rec.update(backward_ms=total, backward_max_rel_err=worst)
                records["bf16" if bf16 else "f32"][key] = rec
                del shapes
    return records


def offset_view(t, offset):
    """``t``, or with ``offset`` a copy of it one element into a new storage."""
    import torch

    if not offset:
        return t.contiguous()
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def any_shape_inputs(gen, spec):
    """KPConv inputs (q, s, inds, x, kernel points, weights, extent) of one
    ANY_SHAPE_BASE-like ``spec`` on the card; with ``offset`` every float
    tensor is a view one element into its storage."""
    import torch

    from diffreg_tpu_torch.ops.kernel_points import load_kernel_points

    b, nq, ns, k, cin, cout, p = (spec[n] for n in ("b", "nq", "ns", "k", "cin", "cout", "p"))
    s_pts = (torch.rand(b, ns, 3, generator=gen) * 0.5).cuda()
    q_pts = s_pts[:, :nq] + 0.005 * torch.randn(b, nq, 3, generator=gen).cuda()
    with torch.no_grad():
        d, j = torch.cdist(q_pts, s_pts).topk(k, largest=False)
    inds = torch.where(d < 0.1, j, ns).int().contiguous()
    x = torch.randn(b, ns, cin, generator=gen).cuda()
    kp = torch.from_numpy(load_kernel_points(0.0625, p, 3, "center")).cuda()
    w = (torch.randn(p, cin, cout, generator=gen) / math.sqrt(p * cin)).cuda()
    return (*(offset_view(t, spec["offset"]) for t in (q_pts, s_pts)), inds,
            *(offset_view(t, spec["offset"]) for t in (x, kp, w)), 0.05)


def any_shape_edges(gen):
    """Phase 23f: the any-shape KPConv kernel, f32 and bf16, at every edge of
    ANY_SHAPE_EDGES against its plain version at phase 1's limits (a bf16 row
    beyond it excused only where one rounding flip of a term explains it; a
    "closest" row only at a near-tie), each launch asserted on the any-shape
    route; the wide K = 58 layer timed beside its plain version; the gradients
    through both autograd Functions at the base (narrow) layer. Returns {"f32"
    | "bf16": {"edges": [...], "wide_k58": record, "backward": record}}."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)

    records = {}
    for bf16 in (False, True):
        counted = kpconv_cuda_bf16 if bf16 else kpconv_cuda
        edges = []
        for change in ANY_SHAPE_EDGES:
            spec = dict(ANY_SHAPE_BASE, **change)
            args = any_shape_inputs(gen, spec)
            q, s_pts, inds, x, kp, w, ext = args
            modes = spec["modes"]
            name = (f"kpconv any-shape{' bf16' if bf16 else ''} "
                    + ", ".join(f"{k} {'/'.join(v) if k == 'modes' else v}"
                                for k, v in change.items()))
            before = dict(counted.route_launches)
            with torch.inference_mode():
                if bf16:
                    table = offset_view(kpconv_bf16_table_aligned(s_pts, x), spec["offset"])
                    wb = offset_view(w.to(torch.bfloat16), spec["offset"])
                    got = kpconv_cuda_bf16(q, table, inds, kp, wb, ext, *modes)
                    ref = kpconv_bf16_plain(q, s_pts, inds, x, kp, w, ext, *modes)
                else:
                    got = kpconv_cuda(q, s_pts, inds, x, kp, w, ext, *modes)
                    ref = kpconv(q, s_pts, inds, x, kp, w, ext, *modes)
                torch.cuda.synchronize()
            routes = {r: n - before.get(r, 0) for r, n in counted.route_launches.items()
                      if n != before.get(r, 0)}
            if routes != {"any_shape_tensor_cores": 1}:
                raise AssertionError(f"{name}: routes {routes}")
            top = float(ref.abs().max())
            allowed = (KPCONV_BF16_REL_TOL * top if bf16 else KPCONV_REL_TOL * max(top, 1.0))
            flips = bf16_flip_rows(*args, modes) if bf16 else None
            err, excused = held_against_plain(got, ref, allowed, name, modes[1],
                                              (q, s_pts, inds, kp, bf16), flips)
            log(f"{name}: err {err:.3e} = {err / max(top, 1e-30):.3e} of max |plain| (limit "
                f"{allowed:.3e}{f'; {excused} rows excused' if excused else ''})")
            edges.append({"change": {k: list(v) if k == "modes" else v
                                     for k, v in change.items()},
                          "max_abs_err": err, "max_abs_plain": top, "excused_rows": excused})
            del args, got, ref
        wide = any_shape_inputs(gen, ANY_SHAPE_WIDE)
        entry, _ = check_kpconv([wide], 1, "one call", " (any-shape wide K 58)", bf16,
                                flip_excuse=True)
        if entry["shapes"][0]["route"] != "any_shape_tensor_cores":
            raise AssertionError(f"the wide K 58 layer took {entry['shapes'][0]['route']}")
        narrow = any_shape_inputs(gen, ANY_SHAPE_BASE)
        key = (ANY_SHAPE_BASE["nq"], ANY_SHAPE_BASE["ns"], ANY_SHAPE_BASE["k"],
               ANY_SHAPE_BASE["cin"], ANY_SHAPE_BASE["cout"])
        grad_err, back_ms = kpconv_gradients({key: [narrow, 1]}, gen, bf16)
        records["bf16" if bf16 else "f32"] = {
            "edges": edges, "max_rel_err": max(e["max_abs_err"] / e["max_abs_plain"]
                                               for e in edges),
            "wide_k58": entry["shapes"][0],
            "backward": {"shape": list(key), "max_rel_err": grad_err, "ms": back_ms}}
        del wide, narrow
    return records


def shape_range_attention(gen):
    """Phase 23b: both attention instances at every D of SHAPE_HEAD_WIDTHS
    against their plain versions (f32 within ATTENTION_ABS_TOL, bf16 within
    ATTENTION_BF16_REL_TOL of the largest plain entry), timed beside the plain
    version and scaled_dot_product_attention, with the bound; the instance
    and any-D branch that ran are read from the wrapper's counts; then calls
    on views offset by one element (SHAPE_OFFSET_WIDTHS), a call whose B * H
    passes the grid's rows, and the gradients through both autograd Functions
    at SHAPE_GRAD_WIDTHS. Returns {"f32" | "bf16": [case records]}."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.ops.attention import (MaskedAttentionBF16Function,
                                                 MaskedAttentionFunction,
                                                 masked_attention_bf16_plain,
                                                 masked_attention_cuda,
                                                 masked_attention_cuda_bf16,
                                                 masked_attention_plain)

    def inputs(b, h, length, keys, d, dtype, offset):
        def draw(*shape):  # a view ``offset`` elements into its storage
            flat = torch.randn(math.prod(shape) + offset, generator=gen).to("cuda", dtype)
            return flat[offset:].view(*shape)
        q = draw(b, h, length, d)
        k, v = draw(b, h, keys, d), draw(b, h, keys, d)
        mask = torch.ones(b, keys, dtype=torch.bool)
        mask[1::2, keys - 37:] = False
        return q, k, v, mask.cuda()

    records = {"f32": [], "bf16": []}
    for bf16 in (False, True):
        kernel, plain, dtype, function = (
            (masked_attention_cuda_bf16, masked_attention_bf16_plain, torch.bfloat16,
             MaskedAttentionBF16Function) if bf16 else
            (masked_attention_cuda, masked_attention_plain, torch.float32,
             MaskedAttentionFunction))
        name = "attention bf16" if bf16 else "attention"
        cases = ([(d, SHAPE_IMAGE_SELF if d == 256 else SHAPE_ATTENTION, 0)
                  for d in SHAPE_HEAD_WIDTHS] + [(d, SHAPE_ATTENTION, 1)
                                                 for d in SHAPE_OFFSET_WIDTHS]
                 + [(54, SHAPE_WIDE_BH, 0)])
        for d, (b, h, length, keys), offset in cases:
            scale = d ** -0.5
            with torch.inference_mode():
                q, k, v, mask = inputs(b, h, length, keys, d, dtype, offset)
                before = dict(kernel.instance_launches), dict(kernel.any_d_branch_launches)
                got = kernel(q, k, v, mask, scale)
                ref = plain(q, k, v, mask, scale)
                torch.cuda.synchronize()
                instance = [i for i, n in kernel.instance_launches.items()
                            if n != before[0].get(i, 0)]
                branch = [i for i, n in kernel.any_d_branch_launches.items()
                          if n != before[1].get(i, 0)]
                err = float((got.float() - ref.float()).abs().max())
                top = float(ref.float().abs().max())
                limit = ATTENTION_BF16_REL_TOL * top if bf16 else ATTENTION_ABS_TOL
                if not (math.isfinite(err) and err <= limit) or len(instance) != 1:
                    raise AssertionError(f"{name} D {d} [{b},{h},{length}x{keys}]: err {err} "
                                         f"(limit {limit}), instances {instance}")
                big = length * keys * b * h * d > 5e9
                ms = time_cuda(lambda: kernel(q, k, v, mask, scale), 5 if big else 20)
                plain_ms = time_cuda(lambda: plain(q, k, v, mask, scale), 3 if big else 10)
                lib_mask = mask[:, None, None, :]
                # SDPA on aligned copies of offset views (its kernels fault on rows
                # aligned to 4 or 2 bytes): the same values
                lq, lk, lv = (t.clone() for t in (q, k, v)) if offset else (q, k, v)
                lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=lib_mask, scale=scale), 5 if big else 20)
                del lq, lk, lv
                bms, by = bound_ms(*attention_work(q, k, mask),
                                   BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
            where = instance[0] + (f", {branch[0]}" if branch else "")
            log(f"{name} D {d} [{b},{h},{length}x{keys}]{' offset 1' if offset else ''} "
                f"(instance {where}): err {err:.3e} = {err / top:.3e} of max |plain| (limit "
                f"{limit:.1e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
                f"bound {bms:.4f} ms ({by})")
            rec = {"d": d, "b": b, "h": h, "l": length, "s": keys, "offset": offset,
                   "instance": instance[0], "branch": branch[0] if branch else None,
                   "max_abs_err": err, "max_abs_plain": top, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
            if (d in SHAPE_GRAD_WIDTHS and (b, h, length, keys) == SHAPE_ATTENTION
                    and not offset):
                rec["backward_max_rel_err"], rec["backward_ms"] = grad_case(
                    f"{name} D {d} [{b},{h},{length}x{keys}]",
                    lambda *a: function.apply(*a, scale), (q, k, v, mask), (0, 1, 2),
                    lambda *a: plain(*a, scale), gen, 1, kernel)
            records["bf16" if bf16 else "f32"].append(rec)
            del q, k, v, got, ref
    return records


def shape_yaml(repo, directory, name):
    """configs/test/3dmatch.yaml with configuration ``name``'s keys
    (SHAPE_CONFIGS), written to ``directory``: (path, raw)."""
    import yaml

    from diffreg_tpu_torch.utils.config import load_yaml

    raw = load_yaml(os.path.join(repo, "configs", "test", "3dmatch.yaml"))
    for section, keys in SHAPE_CONFIGS[name].items():
        raw[section].update(keys)
    raw["exp_dir"] = f"shape-{name.lower()}"
    path = os.path.join(directory, f"3dmatch_{name.lower()}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, raw


def reset_shape_counts():
    """Every count of both kernels' wrappers set to 0."""
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16

    reset_kpconv_counts()
    for wrapper in (masked_attention_cuda, masked_attention_cuda_bf16):
        wrapper.launches = 0
        wrapper.instance_launches = {}
        wrapper.any_d_branch_launches = {}


def shape_counts():
    """The wrappers' counts since ``reset_shape_counts``: KPConv by kernel-point
    count and by kernel (``_routes``), attention by instance and by any-D
    branch (``_branches``), f32 and bf16."""
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16

    return {"kpconv": dict(kpconv_cuda.point_launches),
            "kpconv_bf16": dict(kpconv_cuda_bf16.point_launches),
            "attention": dict(masked_attention_cuda.instance_launches),
            "attention_bf16": dict(masked_attention_cuda_bf16.instance_launches),
            "kpconv_routes": dict(kpconv_cuda.route_launches),
            "kpconv_bf16_routes": dict(kpconv_cuda_bf16.route_launches),
            "attention_branches": dict(masked_attention_cuda.any_d_branch_launches),
            "attention_bf16_branches": dict(masked_attention_cuda_bf16.any_d_branch_launches)}


def add_shape_launches(launches, counts):
    """Add ``counts`` (``shape_counts``) to the run's launches: KPConv at 15
    kernel points and the tuned attention instances to their kernels' totals,
    the any-P and any-D routes to theirs, and those by kernel and branch
    (``<kind>_any_p_tensor_cores`` and ``<kind>_any_shape_tensor_cores`` at
    every P; ``<route>_tensor_cores``, ``<route>_cuda_cores``)."""
    for kind in ("kpconv", "kpconv_bf16"):
        for n_points, n in counts[kind].items():
            launches[kind if n_points == 15 else f"{kind}_any_p"] += n
        for route, n in counts[f"{kind}_routes"].items():
            if route != "tuned":
                launches[f"{kind}_{route}"] += n
    for kind, total in (("attention", "masked_attention"),
                        ("attention_bf16", "masked_attention_bf16")):
        for instance, n in counts[kind].items():
            launches[f"{total}_any_d" if instance == "any" else total] += n
        for branch, n in counts[f"{kind}_branches"].items():
            launches[f"{total}_any_d_{branch}"] += n


def expect_counts(tag, counts, want):
    """Raise unless the counts (``shape_counts``) are ``want`` (kinds not
    named: none)."""
    full = {key: {} for key in counts}
    full.update(want)
    if counts != full:
        raise AssertionError(f"{tag}: launches {counts}, want {full}")


def kpconv_routes(n_points, n):
    """The KPConv kernels an encode's 11 layers launch ``n`` times over at
    ``n_points``: at the 10 layers of Cin >= 64 the tuned kernel at 15, else
    the any-P tensor-core kernel; at the first (Cin = 1) the any-shape
    kernel."""
    wide = "tuned" if n_points == 15 else "any_p_tensor_cores"
    return {wide: 10 * n, "any_shape_tensor_cores": n}


def run_shape_ddim(name, cfg, batch, one, x_init, u, spec, launches, bf16=False):
    """Configuration ``name`` (``cfg`` at gate 0 and 40, or at gate 0 in bf16)
    on the 4 pairs: the DDIM path through ``register`` with its launches
    counted by route. Returns ({gate: output}, {gate: model}, record)."""
    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import with_condition_gate, with_fast_path

    n_points = cfg.kpfcn.num_kernel_points
    per_run = STEPS * attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    d = cfg.coarse_transformer.feature_dim // cfg.coarse_transformer.n_head
    tuned = (d <= (144 if bf16 else 136) and d % 4 == 0)
    instance = ("any" if not tuned else "112" if d <= 112 and bf16 else
                "144" if bf16 else "64" if d <= 64 else "112" if d <= 112 else "136")
    kinds = ("kpconv_bf16", "attention_bf16") if bf16 else ("kpconv", "attention")
    results, models, record = {}, {}, {}
    for gate in ((0.0,) if bf16 else GATES):
        gated = with_condition_gate(cfg, gate)
        model = models[gate] = DiffusionMatchingModel(with_fast_path(gated) if bf16 else gated,
                                                      device="cuda", seed=0)
        register(model, batch, x_init, u)                      # warm-up
        reset_shape_counts()
        out, seconds = wall(lambda: register(model, batch, x_init, u))
        counts = shape_counts()
        want = {kinds[0]: {n_points: 11}, kinds[1]: {instance: per_run},
                f"{kinds[0]}_routes": kpconv_routes(n_points, 1)}
        if instance == "any":
            want[f"{kinds[1]}_branches"] = {"tensor_cores": per_run}
        expect_counts(f"configuration {name}{' bf16' if bf16 else ''} gate {gate}", counts, want)
        add_shape_launches(launches, counts)
        check_outputs(out, f"configuration {name} gate {gate}")
        results[gate] = out
        key = f"pairs_per_s{'_bf16' if bf16 else ''}_gate_{gate:g}"
        record[key] = BATCH_PAIRS / seconds
        log(f"configuration {name}{' bf16' if bf16 else ''} gate {gate}: {BATCH_PAIRS} pairs in "
            f"{seconds:.4f} s = {BATCH_PAIRS / seconds:.3f} pairs/s; launches {counts}")
    return results, models, record


def run_shape_c(cfg, batch, one, x_init, u, spec, launches, gen):
    """Phase 23c: configuration C on the 4 pairs: the DDIM at gate 0 and 40 in
    f32 through the new routes, the kernels at its shapes (attention at D = 54
    per DDIM step, f32 and bf16), pair 0 card against CPU (the DDIM at gate 0
    by its confidences; at gate 40 from a start clear of the gate with the
    CPU's top-k choices kept, confidences and pose; backbone_forward at phase
    6's limits), one train step at gate 200 card against CPU at phase 8's
    limits, and one bf16 DDIM with pair 0 at phase 8b's limits. Returns the
    record and the two attention entries at its shapes."""
    import torch

    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import (with_condition_gate, with_fast_path)

    results, models, record = run_shape_ddim("C", cfg, batch, one, x_init, u, spec, launches)
    at = [check_attention(batch, cfg, gen, " (C)", bf16) for bf16 in (False, True)]
    # pair 0 at gate 0 and backbone_forward, card against CPU
    cpu_model = DiffusionMatchingModel(with_condition_gate(cfg, 0.0), device="cpu", seed=0)
    t0 = time.perf_counter()
    ref = register(cpu_model, one, x_init[:1], u[:1], device="cpu")
    check_outputs(ref, "configuration C CPU")
    record["pair0"] = variant_pair0("C", results[0.0], ref, one,
                                    f"configuration C DDIM gate 0 (CPU "
                                    f"{time.perf_counter() - t0:.1f} s)")
    backbone = {"kpconv": 0, "masked_attention": 0}
    reset_shape_counts()
    run_backbone(models[0.0], batch, cpu_model, one, backbone)
    counts = shape_counts()
    # a warm-up and TIMED_RUNS calls, then one encode on the card
    expect_counts("configuration C backbone_forward", counts,
                  {"kpconv": {24: (TIMED_RUNS + 2) * 11},
                   "kpconv_routes": kpconv_routes(24, TIMED_RUNS + 2),
                   "attention": {"any": (TIMED_RUNS + 1) * 6},
                   "attention_branches": {"tensor_cores": (TIMED_RUNS + 1) * 6}})
    add_shape_launches(launches, counts)
    del cpu_model
    # pair 0 at gate 40, the card keeping the CPU's top-k choices
    seed, x0, u0, clear = variant_gate_start(models[40.0], one)
    cpu_gated = DiffusionMatchingModel(with_condition_gate(cfg, 40.0), device="cpu", seed=0)
    choices, cut = [], int(max(one.src_mask.sum(), one.tgt_mask.sum()))
    with topk_choices(record=choices):
        ref = register(cpu_gated, one, x0, u0, device="cpu")
    del cpu_gated
    with topk_choices(replay=choices, cut=cut) as seen:
        got = register(models[40.0], one.to("cuda"), x0.cuda(), u0.cuda())
    check_outputs(ref, "configuration C CPU gate 40")
    tag = "configuration C DDIM gate 40"
    record["pair0_gate_40"] = variant_pair0(
        "C", got, ref, one, f"{tag} (start seed {seed}, conditions {clear:.3f} from the gate, "
        f"the CPU's top-k choices in {seen['calls']} Procrustes calls: {seen['differ']} entries "
        f"of the card's own differ, {seen['far']} farther than {TOPK_CUT_REL:.0e} of the cut)",
        pose=True)
    check_replayed(seen, cut, tag)
    f32_gate0 = results[0.0]
    del models, results, got
    torch.cuda.empty_cache()
    # one train step at gate 200, card against CPU
    reset_shape_counts()
    record["train_step"] = train_step_card_vs_cpu(with_condition_gate(cfg, 200.0), one,
                                                  tag=" configuration C")
    add_shape_launches(launches, shape_counts())
    # one bf16 DDIM at gate 0, pair 0 card against CPU
    bf16_out, _, bf16_rec = run_shape_ddim("C", cfg, batch, one, x_init, u, spec, launches,
                                           bf16=True)
    record.update(bf16_rec)
    cpu_bf16 = DiffusionMatchingModel(with_fast_path(with_condition_gate(cfg, 0.0)),
                                      device="cpu", seed=0)
    ref = register(cpu_bf16, one, x_init[:1], u[:1], device="cpu")
    bf16_pair_check(bf16_out[0.0], ref, f32_gate0, one, cpu_bf16, "configuration C gate 0")
    return record, at


def run_shape_w(cfg, batch, one, x_init, u, spec, launches, gen):
    """Phase 23d: configuration W on the 4 pairs: the DDIM at gate 0 in f32 and
    bf16 (attention through the any-D instance at D = 216), the attention
    kernel at its shapes per DDIM step, and pair 0 card against CPU at phase
    23c's limits. Returns the record and the two attention entries."""
    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import with_fast_path

    results, _, record = run_shape_ddim("W", cfg, batch, one, x_init, u, spec, launches)
    at = [check_attention(batch, cfg, gen, " (W)", bf16) for bf16 in (False, True)]
    cpu_model = DiffusionMatchingModel(cfg, device="cpu", seed=0)
    ref = register(cpu_model, one, x_init[:1], u[:1], device="cpu")
    record["pair0"] = variant_pair0("W", results[0.0], ref, one, "configuration W DDIM gate 0")
    bf16_out, _, bf16_rec = run_shape_ddim("W", cfg, batch, one, x_init, u, spec, launches,
                                           bf16=True)
    record.update(bf16_rec)
    cpu_bf16 = DiffusionMatchingModel(with_fast_path(cfg), device="cpu", seed=0)
    ref = register(cpu_bf16, one, x_init[:1], u[:1], device="cpu")
    bf16_pair_check(bf16_out[0.0], ref, results[0.0], one, cpu_bf16, "configuration W gate 0")
    return record, at


def run_shape_cli(repo, c_path, directory, launches):
    """Phase 23e: ``diffreg_tpu_torch.main`` on the card on configuration C's
    YAML (--demo) and on configs/test/4dmatch.yaml with one head of 528
    (--demo --thr 0.55), each on BATCH_PAIRS pairs in one batch, with the
    launches counted by route. Returns the runs' records."""
    import yaml

    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.utils.config import build_pipeline_config, load_yaml

    raw4 = load_yaml(os.path.join(repo, "configs", "test", "4dmatch.yaml"))
    raw4["coarse_transformer"]["n_head"] = 1
    raw4["exp_dir"] = "shape-4dmatch-d528"
    path4 = os.path.join(directory, "4dmatch_d528.yaml")
    with open(path4, "w") as f:
        yaml.safe_dump(raw4, f)
    _, demo_spec, _ = synthetic_batch(batch_size=1, n_points=768, seed=0)
    runs = {}
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        for name, path, extra, keys in (("C", c_path, [], ("IR", "FMR", "RR")),
                                        ("4DMatch D 528", path4, ["--thr", "0.55"], ("IR",))):
            cfg = build_pipeline_config(load_yaml(path))
            d = cfg.coarse_transformer.feature_dim // cfg.coarse_transformer.n_head
            want_at = STEPS * attention_calls(demo_spec.n_src, demo_spec.n_tgt,
                                              cfg.denoising_layer_types)
            reset_shape_counts()
            summary, seconds = wall(lambda: cli(["--config", path, "--demo", "--num-pairs",
                                                 str(BATCH_PAIRS), "--batch-size",
                                                 str(BATCH_PAIRS), *extra]))
            counts = shape_counts()
            # main calibrates its own K (up to 58 on the demo's data): a layer
            # past K = 40 takes the any-shape kernel, so only the total, the
            # wide layers' route and the first layer's are fixed here
            routes = counts["kpconv_routes"]
            n_points = cfg.kpfcn.num_kernel_points
            wide = "tuned" if n_points == 15 else "any_p_tensor_cores"
            if sum(routes.values()) != 11 or not routes.get(wide) or not routes.get(
                    "any_shape_tensor_cores") or set(routes) - {wide, "any_shape_tensor_cores"}:
                raise AssertionError(f"main {name}: KPConv routes {routes}")
            expect_counts(f"main {name}", counts,
                          {"kpconv": {n_points: 11}, "kpconv_routes": routes,
                           "attention": {"any": want_at},
                           "attention_branches": {"tensor_cores": want_at}})
            add_shape_launches(launches, counts)
            if not all(math.isfinite(summary[k]) for k in keys):
                raise AssertionError(f"main {name}: summary {summary}")
            log(f"main {name} (D {d}, P {cfg.kpfcn.num_kernel_points}, --demo), {BATCH_PAIRS} "
                f"pairs: {seconds:.2f} s, launches {counts}; " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in summary.items()))
            runs[name] = {"seconds": seconds, "d": d, **{k: summary[k] for k in keys}}
    finally:
        os.chdir(cwd)
    return runs


def run_shape_range(repo, batch, batch_cpu, spec, x_init, u, launches, gen):
    """Phase 23: the kernels over their shape range (a, b), configurations C (c)
    and W (d) at full width, the CLI on C's YAML and on 4DMatch at D = 528 (e).
    Each part's runs must launch the new routes. Returns the four JSON entries
    of the new routes (f32 and bf16 any-P KPConv, f32 and bf16 any-D
    attention)."""
    import tempfile

    import torch

    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.utils.config import build_pipeline_config

    t0 = time.perf_counter()
    one = batch_cpu.select(slice(0, 1))
    with tempfile.TemporaryDirectory() as tmp:
        c_path, c_raw = shape_yaml(repo, tmp, "C")
        _, w_raw = shape_yaml(repo, tmp, "W")
        cfg_c, cfg_w = build_pipeline_config(c_raw), build_pipeline_config(w_raw)
        model = DiffusionMatchingModel(cfg_c, device="cuda", seed=0)
        calls = kpconv_layer_calls(model, lambda: model.encode(batch), KPConv)
        del model
        points = shape_range_kpconv(calls, gen)
        del calls
        torch.cuda.empty_cache()
        edges = any_shape_edges(gen)
        torch.cuda.empty_cache()
        widths = shape_range_attention(gen)
        t_kernels = time.perf_counter() - t0
        record_c, at_c = run_shape_c(cfg_c, batch, one, x_init, u, spec, launches, gen)
        torch.cuda.empty_cache()
        record_w, at_w = run_shape_w(cfg_w, batch, one, x_init, u, spec, launches, gen)
        torch.cuda.empty_cache()
        cli = run_shape_cli(repo, c_path, tmp, launches)
    for key in ("kpconv_any_p_tensor_cores", "kpconv_bf16_any_p_tensor_cores",
                "kpconv_any_shape_tensor_cores", "kpconv_bf16_any_shape_tensor_cores",
                "masked_attention_any_d_tensor_cores", "masked_attention_bf16_any_d_tensor_cores"):
        if not launches[key]:
            raise AssertionError(f"phase 23: the route {key} was not launched on the path")
    entries = []
    for bf16 in (False, True):
        dtype = "bf16" if bf16 else "f32"
        rec = points[dtype]["24"]
        name = "kpconv_bf16_any_p" if bf16 else "kpconv_any_p"
        entries.append({
            "name": name, "route": "cuda", "source": "diffreg_tpu_torch/csrc/kpconv_common.cuh",
            "compiled_into": f"diffreg_tpu_torch/csrc/{'kpconv_bf16' if bf16 else 'kpconv'}.cu",
            "replaces": "diffreg_tpu/ops/pallas/kpconv_kernel.py:38",
            "launches": launches[name],
            "route_launches": {"any_p_tensor_cores": launches[f"{name}_tensor_cores"]},
            "max_abs_err": max(r["max_abs_err"] for r in points[dtype].values()),
            **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "per": "configuration C's encode (11 calls, P = 24)",
            "points": points[dtype]})
    for bf16 in (False, True):
        dtype = "bf16" if bf16 else "f32"
        c, w = at_c[bf16], at_w[bf16]
        name = "masked_attention_bf16_any_d" if bf16 else "masked_attention_any_d"
        entries.append({
            "name": name, "route": "cuda", "source": "diffreg_tpu_torch/csrc/attention.cu",
            "replaces": "diffreg_tpu/ops/pallas/attention_kernel.py:24",
            "launches": launches[name],
            "branch_launches": {k: launches[f"{name}_{k}"] for k in ("tensor_cores", "cuda_cores")},
            "max_abs_err": max([c["max_abs_err"], w["max_abs_err"]]
                               + [r["max_abs_err"] for r in widths[dtype]]),
            **{k: c[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "per": f"one DDIM step of configuration C (D 54, {c['per']})",
            "d216": {k: w[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "per")},
            **{f"d{r['d']}_{r['l']}": {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                          "bound_by", "library_ms")}
               for r in widths[dtype] if r["d"] in (256, 528) and not r["offset"]},
            "shapes": c["shapes"] + w["shapes"], "widths": widths[dtype]})
    entries[0]["configurations"] = {"C": record_c, "W": record_w, "cli": cli}
    entries[0]["any_shape_edges"] = edges   # moved to the any-shape entries (any_shape_entries)
    log(f"phase 23 (the shape range): {time.perf_counter() - t0:.1f} s (kernels "
        f"{t_kernels:.1f} s)")
    return entries


# ---------------------------------------------------------------- the library surface (phase 24)


def rel_err(got, ref):
    """max |got - ref| over max |ref| (CPU tensors or arrays)."""
    import numpy as np

    got = np.asarray(got.detach().cpu() if hasattr(got, "detach") else got, np.float64)
    ref = np.asarray(ref.detach().cpu() if hasattr(ref, "detach") else ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"shapes {got.shape} and {ref.shape}")
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def held(name, err, limit, record):
    record[name] = err
    if limit is not None and not err <= limit:
        raise AssertionError(f"library {name}: {err:.3e} of the largest entry, limit {limit:.0e}")


class Float32Draws:
    """A draw source giving a float64 run the float32 draws of ``draws``."""

    def __init__(self, draws):
        self.draws = draws

    def split(self, num=2):
        return [self] * num

    def fold_in(self, data):
        return self

    def uniform(self, shape, dtype, minval=0.0, maxval=1.0):
        import torch

        return self.draws.uniform(shape, torch.float32, minval, maxval).to(dtype)

    def normal(self, shape, dtype):
        import torch

        return self.draws.normal(shape, torch.float32).to(dtype)

    def gamma(self, alpha, shape, dtype):
        import torch

        return self.draws.gamma(alpha, shape, torch.float32).to(dtype)

    def gumbel(self, shape, dtype):
        import torch

        return self.draws.gumbel(shape, torch.float32).to(dtype)


def held_against_f64(name, card, cpu, exact, record):
    """The card's f32 result no further from a float64 run than
    LIB_F64_FACTOR times the CPU's f32 result is, plus LIB_REL of the largest
    entry: for outputs whose f32 rounding the computation itself amplifies."""
    import torch

    scale = float(exact.abs().max())
    e_card = float((card.double() - exact).abs().max())
    e_cpu = float((cpu.double() - exact).abs().max())
    record[name] = {"card_vs_f64": e_card / scale, "cpu_vs_f64": e_cpu / scale}
    if not e_card <= LIB_F64_FACTOR * e_cpu + LIB_REL * scale:
        raise AssertionError(f"library {name}: the card {e_card / scale:.3e} from float64, the "
                             f"CPU {e_cpu / scale:.3e}")


def timed_pair(fn_card, fn_cpu, iters=3):
    """(card result, card ms a call, CPU result, CPU ms)."""
    out = fn_card()
    ms = time_cuda(fn_card, iters, warmup=0)
    t0 = time.perf_counter()
    ref = fn_cpu()
    return out, ms, ref, (time.perf_counter() - t0) * 1e3


def neighbour_differences(card, cpu, pts, radius):
    """Entries where the card's and the CPU's neighbour indices differ, and how
    many of them a tie (equal distances within rounding) or a straddle of the
    radius (one side the sentinel, the other's distance at r^2 within
    rounding) explains. ``card``/``cpu`` [R, K] over supports ``pts``."""
    import torch

    diff = card != cpu
    n = int(diff.sum())
    if n == 0:
        return 0, 0
    ns = pts.shape[0]
    rows = torch.nonzero(diff)[:, 0]
    a, b = card[diff].long(), cpu[diff].long()
    q = pts[rows]
    sq = lambda i: torch.where(i < ns, ((pts[i.clamp(max=ns - 1)] - q) ** 2).sum(-1),
                               torch.full_like(q[:, 0], float("inf")))
    da, db = sq(a), sq(b)
    r2 = float(radius) ** 2
    finite = lambda d: torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    tol = 4 * 2.0 ** -23 * torch.clamp(torch.maximum(finite(da), finite(db)),
                                       min=r2 if math.isfinite(r2) else 0.0)
    tie = (da - db).abs() <= tol
    straddle = ((a >= ns) & ((db - r2).abs() <= tol)) | ((b >= ns) & ((da - r2).abs() <= tol))
    return n, int((tie | straddle).sum())


def lib_neighbours(name, pts, valid, radius, k, record):
    """(a) radius_neighbors and knn on one padded level, card against CPU (the
    first LIB_CPU_ROWS query rows) and against the native C++ search."""
    import numpy as np
    import torch

    from diffreg_tpu_torch.data.native import radius_neighbors_native
    from diffreg_tpu_torch.ops.neighbors import knn, radius_neighbors

    rows = min(LIB_CPU_ROWS, pts.shape[0])
    pc, vc = pts.cuda(), valid.cuda()
    card, ms, cpu, cpu_ms = timed_pair(
        lambda: radius_neighbors(pc, vc, pc, vc, radius, k),
        lambda: radius_neighbors(pts[:rows], valid[:rows], pts, valid, radius, k))
    card = card.cpu()
    n_diff, n_explained = neighbour_differences(card[:rows], cpu, pts, radius)
    if n_diff != n_explained:
        raise AssertionError(f"library {name} radius_neighbors: {n_diff - n_explained} of "
                             f"{n_diff} differing entries card vs CPU are not ties")
    n_real = int(valid.sum())
    real = pts[:n_real].numpy()
    t0 = time.perf_counter()
    native = radius_neighbors_native(real, real, radius, k)
    native_ms = (time.perf_counter() - t0) * 1e3
    native = torch.from_numpy(np.where(native >= n_real, pts.shape[0], native))
    nat_diff, nat_explained = neighbour_differences(card[:n_real], native, pts, radius)
    same_sets = sum(set(a.tolist()) == set(b.tolist())
                    for a, b in zip(card[:n_real], native))
    (kidx, kdist), kms, (kidx_cpu, kdist_cpu), kcpu_ms = timed_pair(
        lambda: knn(pc, vc, pc, vc, k),
        lambda: knn(pts[:rows], valid[:rows], pts, valid, k))
    k_diff, k_explained = neighbour_differences(kidx.cpu()[:rows], kidx_cpu, pts, float("inf"))
    if k_diff != k_explained:
        raise AssertionError(f"library {name} knn: {k_diff - k_explained} differing entries "
                             f"card vs CPU are not ties")
    held(f"{name}_knn_distances", rel_err(kdist.cpu()[:rows], kdist_cpu), LIB_REL, record)
    log(f"library {name}: radius_neighbors [{pts.shape[0]} x {pts.shape[0]}] K {k} r {radius}: "
        f"card {ms:.3f} ms, CPU {cpu_ms:.1f} ms ({rows} rows), native C++ {native_ms:.1f} ms; "
        f"card vs CPU {n_diff} entries differ ({n_explained} ties/straddles); card vs native "
        f"{nat_diff} entries differ ({nat_explained} ties/straddles), "
        f"{n_real - same_sets} of {n_real} rows hold another set; knn card {kms:.3f} ms, CPU "
        f"{kcpu_ms:.1f} ms, {k_diff} entries differ ({k_explained} ties)")
    record[f"{name}_ms"] = {"radius_neighbors": ms, "radius_neighbors_cpu": cpu_ms,
                            "native": native_ms, "knn": kms, "knn_cpu": kcpu_ms}
    record[f"{name}_differences"] = {"cpu": n_diff, "native": nat_diff,
                                     "native_rows_other_set": n_real - same_sets, "knn": k_diff}


def knn_tie_rows(pts, k, card_idx, cpu_idx):
    """Rows whose k nearest (in order) differ card vs CPU; at every position
    where they differ the two picks must lie at the same matmul-form distance
    within rounding (a near-tie at the cut or inside the set)."""
    import torch

    from diffreg_tpu_torch.ops.vision import pairwise_distance

    rows = (card_idx != cpu_idx).any(-1)
    if rows.any():
        d2 = pairwise_distance(pts[rows], pts, squared=True)
        gap = (torch.gather(d2, 1, card_idx[rows].long())
               - torch.gather(d2, 1, cpu_idx[rows].long())).abs()
        scale = float((pts ** 2).sum(-1).max())
        if not bool((gap <= 16 * 2.0 ** -23 * scale).all()):
            raise AssertionError(f"library features: a k-nearest pick differs card vs CPU "
                                 f"beyond rounding (gap {float(gap.max()):.3e})")
    return rows


def lib_features(cloud, record):
    """(c) estimate_normals, build_local_reference_frame and local_ppf on one
    cloud, card against CPU; the LRF and PPF take the CPU's normals on both."""
    import torch

    from diffreg_tpu_torch.ops.features import (build_local_reference_frame,
                                                estimate_normals, local_ppf)
    from diffreg_tpu_torch.ops.topk import stable_top_k
    from diffreg_tpu_torch.ops.vision import pairwise_distance

    cc = cloud.cuda()
    nrm, ms, nrm_cpu, cpu_ms = timed_pair(lambda: estimate_normals(cc, k=LIB_NORMAL_K),
                                          lambda: estimate_normals(cloud, k=LIB_NORMAL_K))
    knn_of = lambda p, k: stable_top_k(-pairwise_distance(p, p, squared=True), k)[1]
    cut_rows = knn_tie_rows(cloud, LIB_NORMAL_K, knn_of(cc, LIB_NORMAL_K).cpu(),
                            knn_of(cloud, LIB_NORMAL_K))
    keep = ~cut_rows
    idx = knn_of(cloud, LIB_NORMAL_K)
    off = cloud[idx] - cloud[idx].mean(dim=1, keepdim=True)
    ev = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", off, off).double())
    bound = LIB_NORMAL_GAP_FACTOR * 2.0 ** -24 * ev[:, 2] / (ev[:, 1] - ev[:, 0]) + LIB_REL
    ratio = ((nrm.cpu() - nrm_cpu).abs().amax(-1).double() / bound)[keep]
    record["normals"] = rel_err(nrm.cpu()[keep], nrm_cpu[keep])
    record["normals_over_gap_bound"] = float(ratio.max())
    record["normals_least_rel_gap"] = float(((ev[:, 1] - ev[:, 0]) / ev[:, 2]).min())
    if not float(ratio.max()) <= 1.0:
        raise AssertionError(f"library normals: {float(ratio.max()):.2f} times the eigengap "
                             f"bound")
    nc = nrm_cpu.cuda()
    lrf, lrf_ms, lrf_cpu, lrf_cpu_ms = timed_pair(
        lambda: build_local_reference_frame(cc[None], nc[None], LIB_LRF_K, True),
        lambda: build_local_reference_frame(cloud[None], nrm_cpu[None], LIB_LRF_K, True))
    lrf_rows = knn_tie_rows(cloud, LIB_LRF_K, knn_of(cc, LIB_LRF_K).cpu(),
                            knn_of(cloud, LIB_LRF_K))
    # the frame's x axis normalises a weighted sum of in-plane offsets that can
    # nearly cancel, so its f32 rounding is not one ulp of the output: the card
    # is held against a float64 run beside the CPU's own f32 distance from it
    lrf64 = build_local_reference_frame(cloud.double()[None], nrm_cpu.double()[None], LIB_LRF_K,
                                        True)
    lrf_rows |= (knn_of(cloud.double(), LIB_LRF_K) != knn_of(cloud, LIB_LRF_K)).any(-1)
    for got, ref, exact, part in zip(lrf, lrf_cpu, lrf64, ("x", "y", "z", "lrf")):
        keep_rows = ~lrf_rows
        held_against_f64(f"lrf_{part}", got.cpu()[0][keep_rows], ref[0][keep_rows],
                         exact[0][keep_rows], record)
    idx = knn_of(cloud, LIB_LRF_K)[None]
    ppf, ppf_ms, ppf_cpu, ppf_cpu_ms = timed_pair(
        lambda: local_ppf(cc[None], cc[None], nc[None], nc[None], idx.cuda()),
        lambda: local_ppf(cloud[None], cloud[None], nrm_cpu[None], nrm_cpu[None], idx))
    held("local_ppf", rel_err(ppf, ppf_cpu), LIB_REL, record)
    log(f"library features on {cloud.shape[0]} points: estimate_normals (k {LIB_NORMAL_K}) card "
        f"{ms:.3f} ms, CPU {cpu_ms:.1f} ms, {int(cut_rows.sum())} rows at a near-tie pick left "
        f"out; LRF (k {LIB_LRF_K}) card {lrf_ms:.3f} ms, CPU {lrf_cpu_ms:.1f} ms, "
        f"{int(lrf_rows.sum())} near-tie rows; local_ppf card {ppf_ms:.3f} ms, CPU "
        f"{ppf_cpu_ms:.1f} ms; max rel err normals {record['normals']:.2e} "
        f"({record['normals_over_gap_bound']:.3f} of the eigengap bound; least relative gap "
        f"{record['normals_least_rel_gap']:.2e}), LRF x axis from float64: card "
        f"{record['lrf_x']['card_vs_f64']:.2e}, CPU {record['lrf_x']['cpu_vs_f64']:.2e}; PPF "
        f"{record['local_ppf']:.2e}")
    record["features_ms"] = {"normals": ms, "normals_cpu": cpu_ms, "lrf": lrf_ms,
                             "lrf_cpu": lrf_cpu_ms, "ppf": ppf_ms, "ppf_cpu": ppf_cpu_ms}


def lib_consistency(src, tgt, record):
    """(d) spatial_consistency and leading_eigenvector on pair 0's
    correspondences."""
    from diffreg_tpu_torch.ops.consistency import leading_eigenvector, spatial_consistency

    sc, ms, sc_cpu, cpu_ms = timed_pair(lambda: spatial_consistency(src.cuda(), tgt.cuda(), 0.1),
                                        lambda: spatial_consistency(src, tgt, 0.1))
    # the a^2 - 2ab + b^2 distances cancel for near points, where each device's
    # matmul order moves the square root by up to sqrt(ulp(|p|^2)): the card is
    # held against a float64 run beside the CPU
    held_against_f64("spatial_consistency", sc.cpu(), sc_cpu,
                     spatial_consistency(src.double(), tgt.double(), 0.1), record)
    m = sc_cpu.cuda()
    ev, ev_ms, ev_cpu, ev_cpu_ms = timed_pair(lambda: leading_eigenvector(m),
                                              lambda: leading_eigenvector(sc_cpu))
    held("leading_eigenvector", rel_err(ev, ev_cpu), LIB_REL, record)
    log(f"library consistency on {src.shape[0]} correspondences: spatial_consistency card "
        f"{ms:.3f} ms, CPU {cpu_ms:.1f} ms (from float64: card "
        f"{record['spatial_consistency']['card_vs_f64']:.2e}, CPU "
        f"{record['spatial_consistency']['cpu_vs_f64']:.2e}); "
        f"leading_eigenvector card {ev_ms:.3f} ms, CPU {ev_cpu_ms:.1f} ms (rel err "
        f"{record['leading_eigenvector']:.2e})")
    record["consistency_ms"] = {"spatial_consistency": ms, "spatial_consistency_cpu": cpu_ms,
                                "leading_eigenvector": ev_ms, "leading_eigenvector_cpu": ev_cpu_ms}


def lib_deformation(src, flow, record):
    """(e) the deformation graph of the 4DMatch source cloud (host C++), then
    Gauss-Newton (5 iterations) and Adam (500) from correspondences under the
    GT flow, card against CPU; the warped source's mean error to src + flow."""
    import numpy as np
    import torch

    from diffreg_tpu_torch.data.graph import (build_deformation_graph_from_point_cloud,
                                              sample_nodes_with_fps)
    from diffreg_tpu_torch.geometry.deformation import (apply_embedded_deformation,
                                                        non_rigid_icp_adam,
                                                        non_rigid_icp_gauss_newton)

    t0 = time.perf_counter()
    node_idx = sample_nodes_with_fps(src, LIB_NODE_COVERAGE)
    nbr, _, nbr_w, anc, _, anc_w = build_deformation_graph_from_point_cloud(
        src, node_idx, 8, 4, LIB_GRAPH_DISTANCE, LIB_NODE_COVERAGE)
    graph_ms = (time.perf_counter() - t0) * 1e3
    ok = nbr >= 0
    edges = np.stack([np.nonzero(ok)[0], nbr[ok]], 1).astype(np.int64)
    edge_w = nbr_w[ok].astype(np.float32)
    anchored = np.nonzero(anc[:, 0] >= 0)[0]
    pick = anchored[np.random.RandomState(3).permutation(len(anchored))[:LIB_CORR]]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    nodes, tgt_all = t(src[node_idx]), t(src + flow)
    inputs = (nodes, t(src[pick]), t((src + flow)[pick]), t(anc[pick]), t(anc_w[pick]),
              t(edges), t(edge_w))
    solvers = {"gauss_newton": (lambda a: non_rigid_icp_gauss_newton(*a[:6], edge_weights=a[6]),
                                LIB_GN_REL),
               "adam": (lambda a: non_rigid_icp_adam(*a, num_iterations=500), LIB_ADAM_REL)}
    card_inputs = [x.cuda() for x in inputs]
    out = {}
    for solver, (fn, limit) in solvers.items():
        (rot, trn), ms, (rot_c, trn_c), cpu_ms = timed_pair(lambda: fn(card_inputs),
                                                            lambda: fn(inputs), iters=1)
        err = max(rel_err(rot, rot_c), rel_err(trn, trn_c))
        held(solver, err, limit, record)
        warped = apply_embedded_deformation(t(src), nodes, rot.cpu(), trn.cpu(), t(anc), t(anc_w))
        real = torch.from_numpy(anc[:, 0] >= 0)
        mean_err = float((warped - tgt_all).norm(dim=-1)[real].mean())
        out[solver] = {"ms": ms, "cpu_ms": cpu_ms, "rel_err": err, "mean_error": mean_err}
    flow_mean = float(np.linalg.norm(flow, axis=1).mean())
    log(f"library deformation: graph of {len(src)} points, {len(node_idx)} nodes, "
        f"{len(edges)} edges in {graph_ms:.1f} ms (host C++); {len(pick)} correspondences under "
        f"the GT flow (mean |flow| {flow_mean:.4f}); Gauss-Newton 5 iterations card "
        f"{out['gauss_newton']['ms']:.1f} ms, CPU {out['gauss_newton']['cpu_ms']:.1f} ms, "
        f"card vs CPU {out['gauss_newton']['rel_err']:.2e}, warped source mean error "
        f"{out['gauss_newton']['mean_error']:.4f}; Adam 500 steps card "
        f"{out['adam']['ms']:.1f} ms, CPU {out['adam']['cpu_ms']:.1f} ms, card vs CPU "
        f"{out['adam']['rel_err']:.2e}, warped source mean error {out['adam']['mean_error']:.4f}")
    for solver in out:
        if not out[solver]["mean_error"] < 0.5 * flow_mean:
            raise AssertionError(f"library {solver}: the warp leaves {out[solver]['mean_error']}"
                                 f" of a mean flow {flow_mean}")
    record["deformation"] = {"graph_ms": graph_ms, "nodes": len(node_idx), **out}


def pnp_problem(batch2d3d, dof):
    """4 pairs of LIB_PNP_POINTS correspondences from the 2D-3D phase's clouds
    and cameras under a known pose (6 DoF: the pair's camera-from-cloud
    transform; 4 DoF: a yaw about the camera's y axis and a translation,
    the cloud re-expressed so that its camera-frame points are the pair's),
    LIB_PNP_OUTLIERS of the pixels moved to random image positions."""
    import numpy as np
    import torch

    from diffreg_tpu_torch.eval.metrics import matrix_to_quaternion

    rs = np.random.RandomState(24 + dof)
    x3d, x2d, poses = [], [], []
    h, w = SENSOR_HW
    for b in range(batch2d3d.batch_size):
        n = int(batch2d3d.masks[0][b].sum())
        pts = batch2d3d.points[0][b, :n].numpy().astype(np.float64)
        tfm = batch2d3d.transform[b].numpy().astype(np.float64)
        cam = pts @ tfm[:3, :3].T + tfm[:3, 3]
        k = batch2d3d.intrinsics[b].numpy().astype(np.float64)
        pix = cam @ k.T
        pix = pix[:, :2] / pix[:, 2:]
        inside = np.nonzero((cam[:, 2] > 0.2) & (pix[:, 0] >= 0) & (pix[:, 0] < w)
                            & (pix[:, 1] >= 0) & (pix[:, 1] < h))[0]
        sel = inside[rs.permutation(len(inside))[:LIB_PNP_POINTS]]
        cam, pix = cam[sel], pix[sel].copy()
        if dof == 6:
            obj = pts[sel]
            q = matrix_to_quaternion(torch.from_numpy(tfm[:3, :3]).float()).double().numpy()
            pose = np.concatenate([tfm[:3, 3], q])
        else:
            yaw, trn = rs.uniform(-np.pi, np.pi), cam.mean(0)
            c, s = np.cos(yaw), np.sin(yaw)
            r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            obj = (cam - trn) @ r                       # r^T (cam - trn)
            pose = np.concatenate([trn, [yaw]])
        out = rs.rand(len(pix)) < LIB_PNP_OUTLIERS
        pix[out] = rs.uniform([0, 0], [w, h], (int(out.sum()), 2))
        x3d.append(obj)
        x2d.append(pix)
        poses.append(pose)
    f = lambda a: torch.from_numpy(np.stack(a).astype(np.float32))
    return f(x3d), f(x2d), batch2d3d.intrinsics.float(), f(poses)


def pose_errors(pose, known, dof):
    """(rotation error deg, translation error) of [B, 4 or 7] poses, in double:
    the wrapped yaw difference (4 DoF) or 2 acos |<q, q_known>| of the
    normalised quaternions (6 DoF), which reads errors far below the limit
    (the trace of an unnormalised f32 quaternion's matrix can pass 3)."""
    import torch

    pose, known = pose.double(), known.double()
    if dof == 4:
        d = pose[:, 3] - known[:, 3]
        rot = torch.atan2(torch.sin(d), torch.cos(d)).abs()
    else:
        q = pose[:, 3:] / pose[:, 3:].norm(dim=-1, keepdim=True)
        k = known[:, 3:] / known[:, 3:].norm(dim=-1, keepdim=True)
        rot = 2.0 * torch.arccos(torch.clamp((q * k).sum(-1).abs(), max=1.0))
    trn = (pose[:, :3] - known[:, :3]).norm(dim=-1)
    return float(torch.rad2deg(rot).max()), float(trn.max())


def lib_epropnp(batch2d3d, record):
    """(f) monte_carlo_forward, 4 and 6 DoF, card against CPU on the same
    draws (a CPU generator's, copied to the card), the pose against the known
    pose."""
    import torch

    from diffreg_tpu_torch.geometry import epropnp as ep
    from diffreg_tpu_torch.utils.draws import Draws

    for dof in (4, 6):
        x3d, x2d, cams, known = pnp_problem(batch2d3d, dof)
        w2d = torch.full_like(x2d, LIB_PNP_WEIGHT)
        cfg = (ep.EProPnP4DoF if dof == 4 else ep.EProPnP6DoF)(**LIB_MC)

        def run(device, dtype=torch.float32):
            d = lambda a: a.to(device, dtype)
            camera = ep.PerspectiveCamera(d(cams))
            cost = ep.HuberPnPCost(delta=torch.full((x2d.shape[0],), LIB_PNP_DELTA * LIB_PNP_WEIGHT,
                                                    dtype=dtype, device=device))
            draws = Draws(torch.Generator().manual_seed(dof), device=device)
            if dtype == torch.float64:
                draws = Float32Draws(draws)
            return ep.monte_carlo_forward(draws, cfg, d(x3d), d(x2d), d(w2d), camera, cost,
                                          ep.LMConfig(dof=dof), ep.RSLMConfig())

        out, ms, ref, cpu_ms = timed_pair(lambda: run("cuda"), lambda: run("cpu"), iters=1)
        pose_err = rel_err(out[0], ref[0])
        held(f"epropnp{dof}_pose", pose_err, LIB_MC_POSE_REL, record)
        logw_err = rel_err(out[4], ref[4])
        mean = lambda o: (torch.softmax(o[4], dim=0)[..., None] * o[3][..., :3]).sum(0)
        mean_err = rel_err(mean(out).cpu(), mean(ref))
        exact = run("cpu", torch.float64)
        held_against_f64(f"epropnp{dof}_logweights", out[4].cpu(), ref[4], exact[4], record)
        held_against_f64(f"epropnp{dof}_posterior_mean", mean(out).cpu(), mean(ref),
                         mean(exact), record)
        rot_deg, trn_err = pose_errors(out[0].cpu(), known, dof)
        rot_cpu, trn_cpu = pose_errors(ref[0], known, dof)
        log(f"library EPro-PnP {dof} DoF ({x2d.shape[0]} x {x2d.shape[1]} correspondences, "
            f"{int(LIB_PNP_OUTLIERS * 100)}% outliers, Huber delta {LIB_PNP_DELTA} px, "
            f"{cfg.mc_samples} samples in "
            f"{cfg.num_iter} iterations): card {ms:.1f} ms, CPU {cpu_ms:.1f} ms; pose against "
            f"the known pose: card {rot_deg:.2e} deg / {trn_err:.2e}, CPU {rot_cpu:.2e} deg / "
            f"{trn_cpu:.2e}; card vs CPU pose {pose_err:.2e}, log-weights {logw_err:.2e} "
            f"(from float64: card {record[f'epropnp{dof}_logweights']['card_vs_f64']:.2e}, CPU "
            f"{record[f'epropnp{dof}_logweights']['cpu_vs_f64']:.2e}), posterior mean "
            f"translation {mean_err:.2e} (from float64: card "
            f"{record[f'epropnp{dof}_posterior_mean']['card_vs_f64']:.2e}, CPU "
            f"{record[f'epropnp{dof}_posterior_mean']['cpu_vs_f64']:.2e})")
        if not (trn_err <= PNP_POSE_TOL and rot_deg <= PNP_POSE_TOL * 180 / math.pi
                and torch.isfinite(out[4]).all()):
            raise AssertionError(f"library EPro-PnP {dof} DoF: pose {rot_deg} deg / {trn_err}")
        record[f"epropnp{dof}"] = {"ms": ms, "cpu_ms": cpu_ms, "rot_deg": rot_deg,
                                   "trn_err": trn_err}


def lib_render_pack(batch2d3d, record):
    """(g) sample_pdf and volume_render on LIB_RAYS rays of LIB_BINS bins, and
    batch_to_pack / pack_to_batch on the 2D-3D phase's padded node batch."""
    import torch

    from diffreg_tpu_torch.ops.conversion import batch_to_pack, pack_to_batch
    from diffreg_tpu_torch.ops.render import sample_pdf, volume_render
    from diffreg_tpu_torch.utils.draws import Draws

    g = torch.Generator().manual_seed(24)
    z = torch.sort(torch.rand(LIB_RAYS, LIB_BINS + 1, generator=g) * 4 + 0.5, dim=-1).values
    wts = torch.rand(LIB_RAYS, LIB_BINS, generator=g)
    dirs = torch.randn(LIB_RAYS, 3, generator=g)
    sig = torch.randn(LIB_RAYS, LIB_BINS, generator=g) * 2
    col = torch.rand(LIB_RAYS, LIB_BINS, 3, generator=g)
    draws = lambda device: Draws(torch.Generator().manual_seed(25), device=device)
    # inverse-CDF sampling divides by a bin's probability and compositing
    # multiplies many transmittances, so both amplify the devices' different
    # summation orders (cumsum, cumprod): held against a float64 run on the
    # same (float32) draws beside the CPU
    s, ms, s_cpu, cpu_ms = timed_pair(
        lambda: sample_pdf(draws("cuda"), z.cuda(), wts.cuda(), LIB_BINS),
        lambda: sample_pdf(draws("cpu"), z, wts, LIB_BINS))
    held_against_f64("sample_pdf", s.cpu(), s_cpu,
                     sample_pdf(Float32Draws(draws("cpu")), z.double(), wts.double(), LIB_BINS),
                     record)
    zz = z[:, :LIB_BINS]
    render = lambda d, *t: volume_render(*t, sigma_noise=0.5, rng=d, white_background=True)
    v, vms, v_cpu, vcpu_ms = timed_pair(
        lambda: render(draws("cuda"), dirs.cuda(), zz.cuda(), sig.cuda(), col.cuda()),
        lambda: render(draws("cpu"), dirs, zz, sig, col))
    v64 = render(Float32Draws(draws("cpu")), dirs.double(), zz.double(), sig.double(),
                 col.double())
    for got, ref, exact, part in zip(v, v_cpu, v64, ("colors", "depths", "opacities")):
        held_against_f64(f"volume_render_{part}", got.cpu(), ref, exact, record)
    nodes, masks = batch2d3d.points[-1], batch2d3d.masks[-1]
    (packed, lengths, pvalid), pms, ref, pcpu_ms = timed_pair(
        lambda: batch_to_pack(nodes.cuda(), masks.cuda()), lambda: batch_to_pack(nodes, masks))
    back, bms, back_cpu, bcpu_ms = timed_pair(
        lambda: pack_to_batch(packed, lengths, nodes.shape[1]),
        lambda: pack_to_batch(*ref[:2], nodes.shape[1]))
    for got, want in zip((packed, lengths, pvalid) + tuple(back), tuple(ref) + tuple(back_cpu)):
        if not torch.equal(got.cpu(), want):
            raise AssertionError("library batch_to_pack / pack_to_batch: card and CPU differ")
    if not torch.equal(back_cpu[0][masks], nodes[masks]):
        raise AssertionError("library pack_to_batch does not restore the node batch")
    log(f"library render: sample_pdf [{LIB_RAYS} x {LIB_BINS}] card {ms:.3f} ms, CPU "
        f"{cpu_ms:.1f} ms; volume_render card {vms:.3f} ms, CPU {vcpu_ms:.1f} ms; pack of "
        f"{tuple(nodes.shape)} nodes card {pms:.3f} ms, CPU {pcpu_ms:.2f} ms, unpack card "
        f"{bms:.3f} ms, CPU {bcpu_ms:.2f} ms")
    record["render_ms"] = {"sample_pdf": ms, "sample_pdf_cpu": cpu_ms, "volume_render": vms,
                           "volume_render_cpu": vcpu_ms, "batch_to_pack": pms,
                           "batch_to_pack_cpu": pcpu_ms, "pack_to_batch": bms,
                           "pack_to_batch_cpu": bcpu_ms}


def run_library(card, batch3d_cpu, corr0, pair4d, batch2d3d, spec2d3d):
    """Phase 24: the library surface on the card at the system's data sizes,
    each part against the CPU. ``corr0``: pair 0's correspondences (source and
    target points) from phase 4; ``pair4d``: phase 9's pair 0 (source, flow)."""
    import numpy as np
    import torch

    from diffreg_tpu_torch.data.synthetic import make_cloud
    from diffreg_tpu_torch.ops.sampling import farthest_point_sampling

    t_phase = time.perf_counter()
    record = {}
    # (a) neighbours: the 3DMatch phase's level 0 of pair 0 (pyramid radius 0.03 x 2.5,
    # the spec's K) and the 2D-3D phase's (its init radius and K)
    lib_neighbours("3dmatch_level0", batch3d_cpu.points[0][0], batch3d_cpu.masks[0][0],
                   0.03 * 2.5, batch3d_cpu.neighbors[0].shape[-1], record)
    lib_neighbours("2d3d_level0", batch2d3d.points[0][0], batch2d3d.masks[0][0],
                   spec2d3d.init_radius, spec2d3d.k_neighbors[0], record)
    # (b) FPS of LIB_FPS_SAMPLES points from the 2D-3D phase's 30,000-point cloud
    pts, valid = batch2d3d.points[0][0], batch2d3d.masks[0][0]
    (idx, mask), ms, (idx_cpu, mask_cpu), cpu_ms = timed_pair(
        lambda: farthest_point_sampling(pts.cuda(), valid.cuda(), LIB_FPS_SAMPLES),
        lambda: farthest_point_sampling(pts, valid, LIB_FPS_SAMPLES), iters=1)
    if not (torch.equal(idx.cpu(), idx_cpu) and torch.equal(mask.cpu(), mask_cpu)):
        raise AssertionError(f"library FPS: {int((idx.cpu() != idx_cpu).sum())} indices differ")
    log(f"library FPS: {LIB_FPS_SAMPLES} of {int(valid.sum())} points, card {ms:.1f} ms, "
        f"CPU {cpu_ms:.1f} ms, indices identical")
    record["fps_ms"] = {"card": ms, "cpu": cpu_ms}
    # (c) point features on one 4,096-point cloud of the 3DMatch phase's generator
    cloud = torch.from_numpy(make_cloud(np.random.RandomState(0), N_POINTS).astype(np.float32))
    lib_features(cloud, record)
    # (d) consistency on phase 4's pair-0 correspondences (its coarse ground truth with
    # outliers should the random-weight DDIM have extracted fewer than 32)
    if corr0[0].shape[0] < 32:
        log(f"library consistency: phase 4 extracted {corr0[0].shape[0]} correspondences for "
            f"pair 0; the coarse ground truth with outliers takes their place")
        corr0 = synthetic_correspondences(batch3d_cpu)
    lib_consistency(*corr0, record)
    # (e) deformation on phase 9's pair 0
    lib_deformation(*pair4d, record)
    # (f) EPro-PnP on the 2D-3D clouds and cameras
    lib_epropnp(batch2d3d, record)
    # (g) render and pack
    lib_render_pack(batch2d3d, record)
    record["seconds"] = time.perf_counter() - t_phase
    log(f"library phase: {record['seconds']:.1f} s on {card}")
    log(f"library: {json.dumps(record)}")
    if record["seconds"] > 60:
        raise AssertionError(f"library phase took {record['seconds']:.1f} s (limit 60)")
    return record


# ---------------------------------------------------------------- the model zoo (phase 25)


def zoo_level_counts(batch_cpu, pcfg):
    """Each pair's (source, target) point count at every pyramid level (the
    packed rows hold the source first): the phase's pairs made again from
    their seed and subsampled as the pyramid subsamples them, checked against
    the batch's masks."""
    import numpy as np

    from diffreg_tpu_torch.data.native import grid_subsample_native
    from diffreg_tpu_torch.data.synthetic import make_pair

    rng = np.random.RandomState(0)                # synthetic_batch's seed in path_data
    counts = []
    for b in range(BATCH_PAIRS):
        src, tgt = (a.astype(np.float32) for a in make_pair(rng, N_POINTS)[:2])
        per, r = [(len(src), len(tgt))], pcfg.first_subsampling_dl * pcfg.conv_radius
        for _ in range(pcfg.num_levels - 1):
            dl = 2.0 * r / pcfg.conv_radius
            src = grid_subsample_native(src, dl).astype(np.float32)
            tgt = grid_subsample_native(tgt, dl).astype(np.float32)
            per.append((len(src), len(tgt)))
            r *= 2.0
        for level, (ns, nt) in enumerate(per):
            if int(batch_cpu.masks[level][b].sum()) != ns + nt:
                raise AssertionError(f"zoo: pair {b} level {level}: {ns} + {nt} points, the "
                                     f"batch holds {int(batch_cpu.masks[level][b].sum())}")
        counts.append(per)
    return counts


def zoo_split(x, counts, level, cap):
    """Packed rows x [B, N, C] of one level -> (source [B, cap, C], target
    [B, cap, C], source mask [B, cap], target mask [B, cap]), zero-padded."""
    import torch

    b = x.shape[0]
    rows = torch.full((2, b, cap), x.shape[1], dtype=torch.long)
    for i in range(b):
        ns, nt = counts[i][level]
        rows[0, i, :ns] = torch.arange(ns)
        rows[1, i, :nt] = torch.arange(ns, ns + nt)
    rows = rows.to(x.device)
    padded = torch.cat([x, x.new_zeros(b, 1, x.shape[2])], dim=1)
    out = [torch.gather(padded, 1, r[..., None].expand(-1, -1, x.shape[2])) for r in rows]
    masks = rows < x.shape[1]
    return out[0], out[1], masks[0], masks[1]


def zoo_pyramid(batch):
    """The KPConv-FPN's pyramid dict of a PairBatch."""
    return {"points": list(batch.points), "masks": list(batch.masks),
            "neighbors": list(batch.neighbors), "pools": list(batch.pools),
            "upsamples": list(batch.upsamples), "features": batch.features}


def zoo_models():
    """(KPConv-FPN, geometric transformer, lite transformer) at GeoTransformer's
    published 3DMatch width, weights from seed 0 (the same on every device)."""
    import copy

    import torch

    from diffreg_tpu_torch.models.diffusion_matching import init_weights
    from diffreg_tpu_torch.zoo import GeometricTransformer, KPConvFPN, KPConvFPNConfig

    torch.manual_seed(0)
    fpn = KPConvFPN(KPConvFPNConfig(**ZOO_FPN))
    init_weights(fpn, 0)
    gt = GeometricTransformer(blocks=ZOO_BLOCKS, **ZOO_GT)
    init_weights(gt, 1)
    lite = GeometricTransformer(blocks=ZOO_BLOCKS, lite=True, **ZOO_GT)
    init_weights(lite, 2)
    return [m.eval() for m in (fpn, gt, lite)], [copy.deepcopy(m).cuda().eval()
                                                 for m in (fpn, gt, lite)]


def zoo_nodes(feats, batch, counts):
    """(source / target superpoints [B, cap, 3], their masks, their features)
    of level 3, and (points, masks, features) of level 1, split by side."""
    cap3, cap1 = batch.points[3].shape[1], batch.points[1].shape[1]
    s3, t3, sm3, tm3 = zoo_split(batch.points[3], counts, 3, cap3)
    sf3, tf3, _, _ = zoo_split(feats[2], counts, 3, cap3)
    s1, t1, sm1, tm1 = zoo_split(batch.points[1], counts, 1, cap1)
    sf1, tf1, _, _ = zoo_split(feats[0], counts, 1, cap1)
    return (s3, t3, sm3, tm3, sf3, tf3), (s1, t1, sm1, tm1, sf1, tf1)


def zoo_matching(src_c, tgt_c, sm3, tm3):
    """Each pair's superpoint correspondences (superpoint_matching_global_topk
    on the L2-normalised features, dual normalisation)."""
    import torch.nn.functional as F

    from diffreg_tpu_torch.zoo import superpoint_matching_global_topk

    return [superpoint_matching_global_topk(F.normalize(src_c[i], dim=-1),
                                            F.normalize(tgt_c[i], dim=-1), ZOO_CORR, sm3[i],
                                            tm3[i]) for i in range(src_c.shape[0])]


def zoo_partition(level1, nodes):
    """Each side's point-to-node partition of level 1 into patches of
    ZOO_PATCH points (``ops.partition.point_to_node_partition``)."""
    from diffreg_tpu_torch.ops.partition import point_to_node_partition

    s1, t1, sm1, tm1 = level1[:4]
    s3, t3, sm3, tm3 = nodes
    return (point_to_node_partition(s1, s3, sm1, sm3, ZOO_PATCH),
            point_to_node_partition(t1, t3, tm1, tm3, ZOO_PATCH))


def zoo_patches(level1, parts, corr):
    """Each pair's patch points, masks and log-Sinkhorn scores [C, K, K] (the
    patch features' similarity / sqrt(C) with a learned dustbin, sliced off)."""
    import torch

    from diffreg_tpu_torch.ops.sinkhorn import log_sinkhorn

    s1, t1, _, _, sf1, tf1 = level1
    src_part, tgt_part = parts
    pad = lambda a: torch.cat([a, torch.zeros_like(a[:1])])  # noqa: E731 (sentinel row)
    out = []
    for i, (si, ti, scores, _) in enumerate(corr):
        sk, tk = src_part.node_knn_indices[i][si], tgt_part.node_knn_indices[i][ti]
        skm, tkm = src_part.node_knn_masks[i][si], tgt_part.node_knn_masks[i][ti]
        sp, tp = pad(s1[i])[sk], pad(t1[i])[tk]
        sf, tf = pad(sf1[i])[sk], pad(tf1[i])[tk]
        sim = torch.einsum("bnc,bmc->bnm", sf, tf) / math.sqrt(sf.shape[-1])
        dustbin = torch.tensor(ZOO_DUSTBIN, device=sim.device)
        z = log_sinkhorn(sim, dustbin, ZOO_SINKHORN_ITERS, skm, tkm)[:, :-1, :-1]
        out.append((sp, tp, skm, tkm, z, scores, sk, tk))
    return out


def zoo_partition_held(card, cpu, points, nodes, side, record, problems):
    """A side's partition card against CPU: each point assigned to another
    node must lie as near (exact squared distances, float64) to both nodes up
    to ZOO_TIE_REL of the largest squared distance, and each node whose member
    list differs must hold such a point or a near-tie among its members'
    distances. Counts recorded."""
    import torch

    p2n_card, p2n_cpu = card.point_to_node.cpu(), cpu.point_to_node
    pts, nds = points.double(), nodes.double()
    tol = ZOO_TIE_REL * float(((pts[:, :, None] - nds[:, None]) ** 2).sum(-1).amax())
    touched = torch.zeros(cpu.node_masks.shape, dtype=torch.bool)
    flips = (p2n_card != p2n_cpu).nonzero().tolist()
    for b, i in flips:
        a, c = int(p2n_card[b, i]), int(p2n_cpu[b, i])
        da, dc = (float(((pts[b, i] - nds[b, n]) ** 2).sum()) if n >= 0 else math.inf
                  for n in (a, c))
        if not abs(da - dc) <= tol:
            problems.append(f"partition {side}: pair {b} point {i} on node {a} (card) / {c} "
                            f"(CPU), {abs(da - dc):.2e} apart")
        touched[b, max(a, 0)] = touched[b, max(c, 0)] = True
    rows = (card.node_knn_indices.cpu() != cpu.node_knn_indices).any(-1) | \
        (card.node_knn_masks.cpu() != cpu.node_knn_masks).any(-1)
    unexplained = 0
    for b, m in (rows & ~touched).nonzero().tolist():
        members = (p2n_cpu[b] == m).nonzero()[:, 0]
        d2 = ((pts[b, members] - nds[b, m]) ** 2).sum(-1).sort().values
        if not (d2[1:] - d2[:-1] <= tol).any():
            unexplained += 1
    if unexplained:
        problems.append(f"partition {side}: {unexplained} patches differ with no near-tie")
    record[f"partition_{side}"] = {"points_reassigned": len(flips),
                                   "patches_differ": int(rows.sum())}


def zoo_lgr(patches):
    """Each pair's local-to-global registration: (R, t, correspondences kept)."""
    from diffreg_tpu_torch.zoo import LGRConfig, PointMatchingConfig, local_global_registration

    cfg = LGRConfig(matching=PointMatchingConfig(k=3, mutual=True, confidence_threshold=0.05),
                    acceptance_radius=0.1, num_refinement_steps=5)
    outs = []
    for sp, tp, skm, tkm, z, scores, _, _ in patches:
        g_src, g_tgt, g_scores, g_valid, r, t = local_global_registration(sp, tp, skm, tkm, z,
                                                                          scores, cfg)
        outs.append((r, t, g_valid, g_src, g_tgt, g_scores))
    return outs


def zoo_drive(models, batch, counts):
    """GeoTransformer's forward composed of the zoo's pieces on ``batch`` (its
    device): {stage: seconds}, and every stage's outputs."""
    import torch

    fpn, gt = models[0], models[1]
    times, out = {}, {}
    with torch.inference_mode():
        out["feats"], times["backbone"] = wall(lambda: fpn(zoo_pyramid(batch)))
        nodes, level1 = zoo_nodes(out["feats"], batch, counts)
        s3, t3, sm3, tm3, sf3, tf3 = nodes
        _, times["embedding"] = wall(lambda: (gt.embedding(s3, sm3), gt.embedding(t3, tm3)))
        (src_c, tgt_c), t_gt = wall(lambda: gt(s3, t3, sf3, tf3, sm3, tm3))
        times["transformer"] = t_gt - times["embedding"]
        out["corr"], times["matching"] = wall(lambda: zoo_matching(src_c, tgt_c, sm3, tm3))
        out["parts"], times["partition"] = wall(lambda: zoo_partition(level1,
                                                                      (s3, t3, sm3, tm3)))
        out["patches"], times["patches"] = wall(lambda: zoo_patches(level1, out["parts"],
                                                                    out["corr"]))
        out["lgr"], times["lgr"] = wall(lambda: zoo_lgr(out["patches"]))
    out.update(nodes=nodes, level1=level1, src_c=src_c, tgt_c=tgt_c)
    return times, out


def zoo_cut_gap(scores, k):
    """(v[k-1] - v[k]) / max |v| of a score matrix's sorted entries: how far
    the top-k cut lies from a tie."""
    v = scores.reshape(-1).sort(descending=True).values
    return float((v[k - 1] - v[k]) / v.abs().max())


def zoo_dual_scores(src_c, tgt_c, sm, tm):
    """The dual-normalised superpoint scores superpoint_matching_global_topk
    cuts (for the cut gap)."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.ops.vision import pairwise_distance

    s = torch.exp(-pairwise_distance(F.normalize(src_c, dim=-1), F.normalize(tgt_c, dim=-1)))
    s = torch.where(sm[:, None] & tm[None, :], s, torch.zeros_like(s))
    return s / s.sum(1, keepdim=True).clamp_min(1e-12) * (s / s.sum(0, keepdim=True).clamp_min(
        1e-12))


def zoo_grid(points):
    """Coordinates rounded to a 1/256 grid: their squared distances in the
    a^2 - 2ab + b^2 form are exact in f32 (|p| < 4), on any device."""
    import torch

    return torch.round(points * 256.0) / 256.0


def zoo_pair0(card_models, cpu_models, batch_cpu, counts, record, problems):
    """Pair 0 card against CPU, each card stage on the CPU's inputs of that
    stage, so that no discrete choice of an earlier stage carries over.
    Failures are appended to ``problems`` (the phase raises them at its end,
    once every measure is logged)."""
    import torch

    fpn_c, gt_c, lite_c = card_models
    one = batch_cpu.select(slice(0, 1))
    t0 = time.perf_counter()
    _, cpu = zoo_drive(cpu_models, one, counts[:1])
    record["cpu_seconds"] = time.perf_counter() - t0
    _, card = zoo_drive(card_models, one.to("cuda"), counts[:1])
    errs = {}
    for i, (g, r) in enumerate(zip(card["feats"], cpu["feats"])):
        errs[f"backbone_level{(1, 2, 3)[i]}"] = rel_err(g, r)
    s3, t3, sm3, tm3, sf3, tf3 = cpu["nodes"]
    dev = lambda *a: [x.cuda() for x in a]  # noqa: E731
    with torch.inference_mode():
        emb_card, emb_cpu = gt_c.embedding(*dev(s3, sm3)), cpu_models[1].embedding(s3, sm3)
        n = s3.shape[1]
        diag = torch.eye(n, dtype=torch.bool)[None, :, :, None].expand_as(emb_cpu)
        d = (emb_card.cpu() - emb_cpu).abs()
        scale = float(emb_cpu.abs().max())
        errs["embedding_pairs"] = float(d[~diag].max()) / scale
        errs["embedding_self_pairs"] = float(d[diag].max()) / scale
        del emb_card, emb_cpu, d, diag
        src_c, tgt_c = gt_c(*dev(s3, t3, sf3, tf3, sm3, tm3))
        errs["transformer"] = max(rel_err(src_c, cpu["src_c"]), rel_err(tgt_c, cpu["tgt_c"]))
        # the same on the superpoints rounded to a grid: exact self-pair distances
        gs3, gt3 = zoo_grid(s3), zoo_grid(t3)
        for name, model, card_model in (("transformer_grid", cpu_models[1], gt_c),
                                        ("lite_grid", cpu_models[2], lite_c)):
            ref = model(gs3, gt3, sf3, tf3, sm3, tm3)
            got = card_model(*dev(gs3, gt3, sf3, tf3, sm3, tm3))
            errs[name] = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
        ref = cpu_models[2](s3, t3, sf3, tf3, sm3, tm3)
        got = lite_c(*dev(s3, t3, sf3, tf3, sm3, tm3))
        errs["lite"] = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
        # matching on the CPU's transformer outputs
        corr = zoo_matching(*dev(cpu["src_c"], cpu["tgt_c"], sm3, tm3))
        gap = zoo_cut_gap(zoo_dual_scores(cpu["src_c"][0], cpu["tgt_c"][0], sm3[0], tm3[0]),
                          ZOO_CORR)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(corr[0][:2], cpu["corr"][0][:2]))
        errs["matching_scores"] = rel_err(corr[0][2], cpu["corr"][0][2])
        record["matching_cut_gap"] = gap
        record["matching_indices_equal"] = same
        if gap > ZOO_CUT_GAP_MIN and not same:
            problems.append(f"matching: the card's correspondences differ with the cut {gap:.2e} "
                            f"from a tie")
        # the partition on the CPU's nodes, then the patches on the CPU's partition
        level1 = [x.cuda() for x in cpu["level1"]]
        parts = zoo_partition(level1, dev(s3, t3, sm3, tm3))
        for side, k, p, q in (("source", 0, cpu["level1"][0], s3),
                              ("target", 1, cpu["level1"][1], t3)):
            zoo_partition_held(parts[k], cpu["parts"][k], p, q, side, record, problems)
        cpu_parts = [type(part)(*(x.cuda() for x in part)) for part in cpu["parts"]]
        patches = zoo_patches(level1, cpu_parts, [[x.cuda() for x in c] for c in cpu["corr"]])
        for name, k in (("patch_points", 0), ("patch_scores", 4)):
            errs[name] = rel_err(patches[0][k], cpu["patches"][0][k])
        # registration on the CPU's patches
        lgr = zoo_lgr([[x.cuda() for x in p] for p in cpu["patches"]])[0]
        r_cpu, t_cpu, v_cpu = cpu["lgr"][0][:3]
        errs["lgr_rotation"] = float((lgr[0].cpu() - r_cpu).abs().max())
        errs["lgr_translation"] = float((lgr[1].cpu() - t_cpu).abs().max())
        record["pair0_lgr_correspondences"] = {"card": int(lgr[2].sum()), "cpu": int(v_cpu.sum())}
        if not torch.equal(lgr[2].cpu(), v_cpu):
            problems.append("LGR: the card keeps other correspondences than the CPU")
    record["pair0"] = errs
    log(f"zoo pair 0 card vs CPU (CPU {record['cpu_seconds']:.1f} s): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; matching cut gap {gap:.2e} (indices equal: {same}); partition "
        f"{record['partition_source']}, {record['partition_target']}; LGR correspondences "
        f"{record['pair0_lgr_correspondences']}")
    problems += [f"pair 0 {name}: {err:.3e}, limit {ZOO_LIMITS[name]:.0e}"
                 for name, err in errs.items() if not err <= ZOO_LIMITS[name]]
    return cpu


def zoo_known_pose(cpu, record):
    """LGR on the card at the full shapes (256 patches of 64 points: pair 0's
    CPU patches) against a known pose, from scores peaked on the identity
    correspondences."""
    import numpy as np
    import torch

    from diffreg_tpu_torch.zoo import LGRConfig, PointMatchingConfig, local_global_registration

    sp, _, skm, _, _, scores = cpu["patches"][0][:6]
    ang = 0.6
    rot = torch.tensor([[math.cos(ang), -math.sin(ang), 0.0], [math.sin(ang), math.cos(ang), 0.0],
                        [0.0, 0.0, 1.0]])
    trn = torch.tensor([0.3, -0.2, 0.8])
    tp = sp @ rot.T + trn
    k = sp.shape[1]
    score = torch.full((sp.shape[0], k, k), -8.0)
    score[:, torch.arange(k), torch.arange(k)] = 0.0
    cfg = LGRConfig(matching=PointMatchingConfig(k=3, mutual=True, confidence_threshold=0.05),
                    acceptance_radius=0.1, num_refinement_steps=5)
    args = [x.cuda() for x in (sp, tp, skm, skm, score, torch.ones(sp.shape[0]))]
    with torch.inference_mode():
        out, seconds = wall(lambda: local_global_registration(*args, cfg))
    err_r = float((out[4].cpu() - rot).abs().max())
    err_t = float((out[5].cpu() - trn).abs().max())
    record["known_pose"] = {"rotation_err": err_r, "translation_err": err_t,
                            "correspondences": int(out[3].sum()), "ms": seconds * 1e3}
    log(f"zoo LGR on a known pose ({tuple(sp.shape)} patches, {int(out[3].sum())} "
        f"correspondences): rotation {err_r:.2e}, translation {err_t:.2e}, "
        f"{seconds * 1e3:.1f} ms")
    if not (err_r <= ZOO_POSE_TOL and err_t <= ZOO_POSE_TOL) or not np.isfinite(err_r):
        raise AssertionError(f"zoo LGR missed the known pose: {err_r:.2e} / {err_t:.2e}")


def zoo_attention_kernel(sm3, tm3, gen):
    """The attention kernel at the transformer's cross shapes (4 heads of 64,
    the pairs' key masks), against its plain version, with SDPA's time; and
    the relative-position self layer's attention core timed beside SDPA with
    an additive float mask (the open question of a kernel for it)."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.nn.layers2d3d import MultiHeadAttention
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_plain

    h, d = ZOO_GT["num_heads"], ZOO_GT["hidden_dim"] // ZOO_GT["num_heads"]
    n_cross = ZOO_BLOCKS.count("cross")
    scale = d ** -0.5
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "mma_flops": 0.0,
              "flops": 0.0}
    worst, shapes = 0.0, []
    with torch.inference_mode():
        for name, kv_mask in (("cross", tm3), ("cross_back", sm3)):
            b, s = kv_mask.shape
            q, k, v = (torch.randn(b, h, s, d, generator=gen).cuda() for _ in range(3))
            kv_mask = kv_mask.cuda().contiguous()
            before = masked_attention_cuda.launches
            got = masked_attention_cuda(q, k, v, kv_mask, scale)
            ref = masked_attention_plain(q, k, v, kv_mask, scale)
            torch.cuda.synchronize()
            assert masked_attention_cuda.launches == before + 1
            err = float((got - ref).abs().max())
            if not err <= ATTENTION_ABS_TOL:
                raise AssertionError(f"zoo attention {name}: {err:.3e}")
            worst = max(worst, err)
            lib_mask = kv_mask[:, None, None, :]
            ms = time_cuda(lambda: masked_attention_cuda(q, k, v, kv_mask, scale), 20)
            plain_ms = time_cuda(lambda: masked_attention_plain(q, k, v, kv_mask, scale), 10)
            lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=scale), 20)
            work = attention_work(q, k, kv_mask)
            bms, by = bound_ms(*work)
            shapes.append({"case": name + " (zoo)", "b": b, "h": h, "l": s, "s": s, "d": d,
                           "calls": n_cross, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": bms, "bound_by": by, "max_abs_err": err})
            log(f"attention {name} (zoo) [{b},{h},{s}x{s},{d}] x{n_cross}: err {err:.3e}, "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound "
                f"{bms:.4f} ms ({by})")
            for key, val in zip(("ms", "plain_ms", "library_ms", "bytes", "mma_flops", "flops"),
                                (ms, plain_ms, lib_ms, *work)):
                totals[key] += n_cross * val
        # the relative-position self layer (its plain route) beside SDPA with the
        # positional logits as an additive float mask
        b, s = sm3.shape
        c = ZOO_GT["hidden_dim"]
        layer = MultiHeadAttention(c, h, qk_embed_proj=True).cuda().eval()
        x = torch.randn(b, s, c, generator=gen).cuda()
        emb = torch.randn(b, s, s, c, generator=gen).cuda()
        mask = sm3.cuda()
        rel_ms = time_cuda(lambda: layer(x, x, x, mask, qk_embeds=emb), 5)
        q, k, v = (torch.randn(b, h, s, d, generator=gen).cuda() for _ in range(3))
        bias = torch.randn(b, h, s, s, generator=gen).cuda()
        sdpa_bias_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=scale), 20)
        qk = torch.randn(b, s, s, h, d, generator=gen).cuda()
        qq = torch.randn(b, s, h, d, generator=gen).cuda()
        bias_ms = time_cuda(lambda: torch.einsum("bnhc,bnmhc->bhnm", qq, qk), 10)
        proj_ms = time_cuda(lambda: layer.qk_embed_layer(emb), 5)
    relative = {"layer_ms": rel_ms, "qk_embed_proj_ms": proj_ms, "q_qk_einsum_ms": bias_ms,
                "sdpa_float_mask_ms": sdpa_bias_ms, "shape": [b, h, s, s, d]}
    log(f"relative-position self attention [{b},{h},{s}x{s},{d}]: the layer (plain) "
        f"{rel_ms:.3f} ms (qk_embed_layer {proj_ms:.3f} ms, q.qk einsum {bias_ms:.3f} ms); "
        f"SDPA with an additive float mask {sdpa_bias_ms:.3f} ms")
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"])
    return {"ms": totals["ms"], "plain_ms": totals["plain_ms"], "library_ms": totals["library_ms"],
            "bound_ms": bms, "bound_by": by, "max_abs_err": worst,
            "per": f"one GeometricTransformer forward ({2 * n_cross} calls)", "shapes": shapes,
            "relative_position_self": relative}


def zoo_tie_rows(queries, supports, k, radius=None, rel=ZOO_TIE_REL):
    """Query rows [B, N] whose k-th and (k+1)-th squared distances (exact
    differences, float64) lie within ``rel`` of the largest squared distance,
    or (``radius``) whose first k straddle r^2 that closely: where a kNN or
    ball query may pick another neighbour under another rounding."""
    import torch

    q, s = queries.double(), supports.double()
    d2 = ((q[:, :, None, :] - s[:, None, :, :]) ** 2).sum(-1)
    v = d2.topk(k + 1, dim=-1, largest=False).values
    tol = rel * float(d2.max())
    tie = (v[..., k] - v[..., k - 1]) <= tol
    if radius is not None:
        tie = tie | ((v[..., :k] - radius * radius).abs() <= tol).any(-1)
    return tie


def zoo_rows_held(name, got, ref, tie_rows, limit, record):
    """got / ref [B, N, ...] card against CPU: every row at ``limit`` of the
    largest entry but the rows ``tie_rows`` excuses (a neighbourhood cut at a
    near-tie), which are counted."""
    got, ref = got.cpu().double(), ref.double()
    scale = float(ref.abs().max())
    row_err = (got - ref).abs().reshape(*ref.shape[:2], -1).amax(-1) / scale
    bad = row_err > limit
    unexplained = int((bad & ~tie_rows).sum())
    err = float(row_err[~tie_rows].max()) if bool((~tie_rows).any()) else 0.0
    record[name] = {"max_rel_err": err, "rows_excused": int((bad & tie_rows).sum()),
                    "rows": int(bad.numel())}
    if unexplained:
        raise AssertionError(f"zoo {name}: {unexplained} rows beyond {limit:.0e} with no tie")
    return err


@contextlib.contextmanager
def collected(problems, name):
    """Run a check, keeping its failure for the end of the phase (which then
    fails), so that the phase's other measures are still taken and logged."""
    try:
        yield
    except AssertionError as e:
        problems.append(f"{name}: {e}")


def zoo_families(record, gen, problems):
    """Phase 25b-d: every other zoo family, the encoders and the small library
    functions on the card against the CPU, at sizes their users run; failures
    are appended to ``problems``."""
    import copy

    import numpy as np
    import torch

    from diffreg_tpu_torch import ops as pops
    from diffreg_tpu_torch import zoo as pzoo
    from diffreg_tpu_torch.data.synthetic import make_cloud
    from diffreg_tpu_torch.geometry import compose, inverse
    from diffreg_tpu_torch.models.towers import synthesise_tower_weights
    from diffreg_tpu_torch.nn.dinov2 import vit_small_config
    from diffreg_tpu_torch.nn.encoders import CNNandDinov2, VGG19BN
    from diffreg_tpu_torch.utils.draws import Draws

    def pair(module, seed):
        torch.manual_seed(seed)
        synthesise_tower_weights(module, seed)
        return module.eval(), copy.deepcopy(module).cuda().eval()

    def run(name, cpu_fn, card_fn, iters=3):
        with torch.inference_mode():
            out, ms, ref, cpu_ms = timed_pair(card_fn, cpu_fn, iters)
        record.setdefault("ms", {})[name] = {"card": ms, "cpu": cpu_ms}
        return out, ref

    def held_all(name, got, ref, limit):
        err = rel_err(got, ref)
        record[name] = err
        if not err <= limit:
            raise AssertionError(f"zoo {name}: {err:.3e} of the largest entry, limit {limit:.0e}")

    clouds = torch.stack([torch.from_numpy(make_cloud(np.random.RandomState(10 + i), ZOO_POINTS))
                          for i in range(2)])                               # [2, 4096, 3]
    cc = clouds.cuda()
    # (b) PointNet++ set abstraction (ScanNet segmentation's first layer)
    with collected(problems, "set abstraction"):
        cpu_m, card_m = pair(pzoo.SetAbstractionModule(0, (32, 32, 64), 1024, 32, 0.1), 20)
        got, ref = run("set_abstraction", lambda: cpu_m(clouds), lambda: card_m(cc), 1)
        if not torch.equal(got[0].cpu(), ref[0]):
            raise AssertionError("zoo set abstraction: the centroids differ")
        zoo_rows_held("set_abstraction", got[1], ref[1],
                      zoo_tie_rows(ref[0], clouds, 32, 0.1), ZOO_REL, record)
    # PointTransformer block (k 16) on the clouds with 32-d features
    with collected(problems, "point transformer"):
        feats = torch.randn(2, ZOO_POINTS, 32, generator=gen)
        cpu_m, card_m = pair(pzoo.PointTransformerBlock(32, 32, 16), 21)
        got, ref = run("point_transformer", lambda: cpu_m(feats, clouds),
                       lambda: card_m(feats.cuda(), cc))
        zoo_rows_held("point_transformer", got[0], ref[0], zoo_tie_rows(clouds, clouds, 16),
                      ZOO_REL, record)
    # FoldingNet (a 512-d code, the paper's 45 x 45 grid)
    with collected(problems, "foldingnet"):
        code = torch.randn(2, 512, generator=gen)
        cpu_m, card_m = pair(pzoo.FoldingNet(512, 512, 45), 22)
        held_all("foldingnet", *run("foldingnet", lambda: cpu_m(code), lambda: card_m(code.cuda())),
                 ZOO_REL)
    # Vector Neurons (VN-DGCNN's widths: 21 vector channels, 20 neighbours)
    with collected(problems, "vector neurons"):
        vn = torch.randn(2, 1024, 21, 3, generator=gen)
        cpu_m, card_m = pair(torch.nn.Sequential(pzoo.VNLinearLeakyReLU(21, 42),
                                                 pzoo.VNLinearLeakyReLU(42, 42)), 23)
        got, ref = run("vn_linear_leaky", lambda: cpu_m(vn), lambda: card_m(vn.cuda()))
        held_all("vn_linear_leaky", got, ref, ZOO_REL)
        cpu_s, card_s = pair(pzoo.VNStdFeature(42), 24)
        held_all("vn_std_feature", *run("vn_std_feature", lambda: cpu_s(ref)[0],
                                        lambda: card_s(ref.cuda())[0]), ZOO_REL)
        grouped = torch.randn(2, 512, 20, 21, 3, generator=gen)
        cpu_m, card_m = pair(pzoo.VNMaxPool(21), 25)
        got, ref = run("vn_max_pool", lambda: cpu_m(grouped), lambda: card_m(grouped.cuda()))
        with torch.inference_mode():
            dots = (grouped * cpu_m.map_to_dir(grouped)).sum(-1)               # [2, 512, 20, 21]
            top2 = dots.topk(2, dim=-2).values
            tie = ((top2[..., 0, :] - top2[..., 1, :]) <= ZOO_TIE_REL * dots.abs().max()).any(-1)
        zoo_rows_held("vn_max_pool", got, ref, tie, 0.0, record)
    # Predator's GCN (256-d, 4 heads, k 10) on 512 nodes a side
    with collected(problems, "predator gcn"):
        nodes = clouds[:, :512]
        desc = torch.randn(2, 512, 256, generator=gen)
        cpu_m, card_m = pair(pzoo.PredatorGCN(256, 4, 10, ("self", "cross", "self")), 26)
        got, ref = run("predator_gcn", lambda: cpu_m(nodes[:1], nodes[1:], desc[:1], desc[1:]),
                       lambda: card_m(nodes[:1].cuda(), nodes[1:].cuda(), desc[:1].cuda(),
                                      desc[1:].cuda()))
        tie = zoo_tie_rows(nodes, nodes, 11).any()
        record["predator_gcn_knn_tie"] = bool(tie)
        for g, r in zip(got, ref):
            held_all("predator_gcn", g, r, ZOO_DEEP_REL)
    # URR's correspondences (4,096 points a side, 32-d features, 512 a direction)
    with collected(problems, "urr"):
        fa = torch.nn.functional.normalize(torch.randn(ZOO_POINTS, 32, generator=gen), dim=-1)
        fb = torch.nn.functional.normalize(fa + 0.3 * torch.randn(ZOO_POINTS, 32, generator=gen),
                                           dim=-1)
        got, ref = run("urr_correspondences",
                       lambda: pzoo.urr_extract_correspondences(clouds[0], clouds[1], fa, fb, 512),
                       lambda: pzoo.urr_extract_correspondences(cc[0], cc[1], fa.cuda(), fb.cuda(),
                                                                512))
        for g, r in zip(got, ref):
            held_all("urr_correspondences", g, r, ZOO_REL)
    # the differentiable renderer at 480 x 640 (a cloud in front of a Kinect camera)
    with collected(problems, "render"):
        h, w = SENSOR_HW
        pts = clouds[0, :ZOO_RENDER_POINTS] * 0.8 + torch.tensor([0.0, 0.0, 2.5])
        colors = torch.rand(ZOO_RENDER_POINTS, 3, generator=gen)
        intr = torch.tensor([[KINECT_F, 0.0, w / 2], [0.0, KINECT_F, h / 2], [0.0, 0.0, 1.0]])
        got, ref = run("render", lambda: pzoo.differentiable_render(pts, colors, None, intr, h, w,
                                                                    8, 6.0, 4.0),
                       lambda: pzoo.differentiable_render(pts.cuda(), colors.cuda(), None,
                                                          intr.cuda(), h, w, 8, 6.0, 4.0), 1)
        zoo_render_held(got, ref, pts, intr, 6.0, record)
    # Pri3D ResUNet 18 at 480 x 640
    with collected(problems, "resunet18"):
        image = torch.rand(1, 3, h, w, generator=gen)
        cpu_m, card_m = pair(pzoo.ResUNet(1, 18), 27)
        held_all("resunet18", *run("resunet18", lambda: cpu_m(image), lambda: card_m(image.cuda()),
                                   1), ZOO_DEEP_REL)
    # (c) the encoders: VGG19-bn at 480 x 640 (running statistics drawn too), and
    with collected(problems, "encoders"):
        # CNNandDinov2 with ViT-S/14 at 476 x 630
        cpu_m, card_m = pair(VGG19BN(), 28)
        for mod in (cpu_m, card_m):
            for i, bn in enumerate(m for m in mod.modules() if isinstance(m, torch.nn.BatchNorm2d)):
                g = torch.Generator().manual_seed(100 + i)
                bn.running_mean.copy_(torch.randn(bn.num_features, generator=g) * 0.1)
                bn.running_var.copy_(torch.rand(bn.num_features, generator=g) + 0.5)
        got, ref = run("vgg19bn", lambda: cpu_m(image), lambda: card_m(image.cuda()), 1)
        for s in (1, 2, 4, 8):
            held_all(f"vgg19bn_{s}", got[s], ref[s], ZOO_DEEP_REL)
        image14 = image[:, :, :476, :630].contiguous()
        cpu_m, card_m = pair(CNNandDinov2(vit_small_config()), 29)
        got, ref = run("cnn_and_dinov2", lambda: cpu_m(image14), lambda: card_m(image14.cuda()), 1)
        for s in (1, 2, 4, 8, 16):
            held_all(f"cnn_and_dinov2_{s}", got[s], ref[s], ZOO_DEEP_REL)
    # (d) the small library functions
    with collected(problems, "library"):
        zoo_library(record, gen, clouds, Draws, compose, inverse, pops)


def zoo_render_held(got, ref, pts, intr, radius, record):
    """The renderer card against CPU. Its pixel-to-point distances come from
    the a^2 - 2ab + b^2 form at pixel coordinates up to 640, whose absolute
    rounding (~|p|^2 * 6e-8 = 2.5e-2 px^2) can move the choice of the 8
    nearest projections where two lie that close, or a projection across the
    radius: pixels whose 8th and 9th distances^2 (exact, float64) lie within
    ZOO_RENDER_CUT_PX2 of each other, or one of the 8 that close to radius^2,
    are counted and excused, the rest held at ZOO_RENDER_REL."""
    import torch

    h, w = ref[0].shape
    diff = torch.zeros(h, w, dtype=torch.bool)
    for g, r in zip(got[:2], ref[:2]):
        d = (g.cpu().double() - r.double()).abs()
        diff |= (d if d.ndim == 2 else d.amax(-1)) > ZOO_RENDER_REL * float(r.abs().max())
    diff |= got[3].cpu() != ref[3]
    z = pts[:, 2].double()
    px = torch.stack([pts[:, 0].double() * float(intr[0, 0]) / z + float(intr[0, 2]),
                      pts[:, 1].double() * float(intr[1, 1]) / z + float(intr[1, 2])], -1)
    vs, us = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    img = torch.stack([us.reshape(-1), vs.reshape(-1)], -1)[diff.reshape(-1)]
    cut = torch.zeros(h * w, dtype=torch.bool)
    if len(img):                            # the 8th / 9th gap of the differing pixels only
        v = (torch.cdist(img, px) ** 2).topk(9, dim=-1, largest=False).values
        cut[diff.reshape(-1).nonzero()[:, 0]] = ((v[:, 8] - v[:, 7]) <= ZOO_RENDER_CUT_PX2) | \
            ((v[:, :8] - radius * radius).abs() <= ZOO_RENDER_CUT_PX2).any(-1)
    cut = cut.reshape(h, w)
    errs = {}
    for name, g, r in (("depth", got[0], ref[0]), ("colors", got[1], ref[1])):
        d = (g.cpu().double() - r.double()).abs()
        d = d if d.ndim == 2 else d.amax(-1)
        scale = float(r.abs().max())
        bad = d > ZOO_RENDER_REL * scale
        if int((bad & ~cut).sum()):
            raise AssertionError(f"zoo render {name}: {int((bad & ~cut).sum())} pixels beyond "
                                 f"{ZOO_RENDER_REL:.0e} with no near-tie at the 8th projection "
                                 f"or the radius")
        errs[name] = float(d[~cut].max()) / scale
    record["render"] = {**errs, "pixels_at_cut": int(cut.sum()), "pixels": h * w,
                        "mask_differs": int((got[3].cpu() != ref[3]).sum())}
    if int(((got[3].cpu() != ref[3]) & ~cut).sum()):
        raise AssertionError("zoo render: the coverage mask differs away from a near-tie")


def zoo_library(record, gen, clouds, Draws, compose, inverse, pops):
    """Phase 25d: grid_subsample on the 3DMatch phase's 4,096-point clouds
    against grid_subsample_np, and the other small functions card against
    CPU."""
    import numpy as np
    import torch

    from diffreg_tpu_torch.data.synthetic import make_pair

    rng = np.random.RandomState(0)
    lib = {}
    for i in range(BATCH_PAIRS):
        src = make_pair(rng, N_POINTS)[0].astype(np.float32)
        pts = torch.from_numpy(src)
        valid = torch.ones(len(src), dtype=torch.bool)
        (sub, ok, n), ms = wall(lambda: pops.grid_subsample(pts.cuda(), valid.cuda(), 0.03,
                                                            len(src)))
        want = pops.grid_subsample_np(src, 0.03)
        ref = pops.grid_subsample(pts, valid, 0.03, len(src))
        if int(n) != len(want) or not torch.equal(ok.cpu(), ref[1]):
            raise AssertionError(f"zoo grid_subsample pair {i}: {int(n)} voxels, numpy "
                                 f"{len(want)}")
        err = float(np.abs(sub.cpu()[ok.cpu()].numpy() - want).max())
        lib.setdefault("grid_subsample_abs_err", 0.0)
        lib["grid_subsample_abs_err"] = max(lib["grid_subsample_abs_err"], err,
                                            float((sub.cpu() - ref[0]).abs().max()))
        lib.setdefault("grid_subsample_ms", []).append(ms * 1e3)
    if not lib["grid_subsample_abs_err"] <= ZOO_SUBSAMPLE_ABS:
        raise AssertionError(f"zoo grid_subsample: {lib['grid_subsample_abs_err']:.2e}")
    s = torch.randn(4, 512, 512, generator=gen)
    sm = torch.rand(4, 512, generator=gen) > 0.1
    cases = {
        "masked_var": (lambda d: pops.masked_var(s.to(d), sm.to(d), 1)),
        "sinkhorn_conf_matrix": (lambda d: pops.sinkhorn_conf_matrix(
            s.to(d), 1.0, 20, sm.to(d), sm.to(d))),
        "knn_interpolate": (lambda d: pops.knn_interpolate(
            clouds[0, :1024].to(d), clouds[0, 1024:].to(d), clouds[1, 1024:].to(d),
            torch.ones(1024, dtype=torch.bool).to(d),
            torch.ones(ZOO_POINTS - 1024, dtype=torch.bool).to(d))),
        "compose_inverse": (lambda d: torch.cat([
            torch.cat(compose(*inverse(clouds[0, :9].reshape(3, 3, 3).to(d),
                                       clouds[1, :3].reshape(3, 3, 1).to(d)),
                              clouds[0, 9:18].reshape(3, 3, 3).to(d),
                              clouds[1, 3:6].reshape(3, 3, 1).to(d)), -1).reshape(-1)])),
    }
    for name, fn in cases.items():
        with torch.inference_mode():
            got, ms, ref, cpu_ms = timed_pair(lambda: fn("cuda"), lambda: fn("cpu"))
        lib[name] = rel_err(got, ref)
        lib.setdefault("ms", {})[name] = {"card": ms, "cpu": cpu_ms}
        if not lib[name] <= ZOO_REL:
            raise AssertionError(f"zoo {name}: {lib[name]:.3e}")
    with torch.inference_mode():
        got = pops.mutual_topk_correspondences(s.cuda(), 3, 2048)
        ref = pops.mutual_topk_correspondences(s, 3, 2048)
        idx = torch.randint(0, ZOO_POINTS, (64, 32), generator=gen)
        sel = pops.index_select(clouds[0].cuda(), idx.cuda(), 0)
        ov = torch.rand(ZOO_POINTS, generator=gen) * 0.5
        ids, ones = torch.arange(ZOO_POINTS), torch.ones(ZOO_POINTS, dtype=torch.bool)
        props = [pops.superpoint_proposals(ids.to(d), ids.to(d), ov.to(d), ones.to(d), 256,
                                           Draws(torch.Generator().manual_seed(5), d),
                                           probabilistic=True)
                 for d in ("cuda", "cpu")]
    same = torch.equal(got.valid.cpu(), ref.valid) and \
        all(torch.equal(a.cpu()[ref.valid], b[ref.valid]) for a, b in zip(got[:3], ref[:3])) and \
        torch.equal(sel.cpu(), clouds[0][idx]) and \
        all(torch.equal(a.cpu(), b) for a, b in zip(*props))
    lib["index_outputs_equal"] = same
    if not same:
        raise AssertionError("zoo: mutual_topk_correspondences, index_select or "
                             "superpoint_proposals differ card against CPU")
    record["library"] = lib


def run_zoo(card, batch_cpu, gen):
    """Phase 25: the model zoo on the card. (a) GeoTransformer's forward
    composed of the zoo's pieces at the published 3DMatch width on the 4
    pairs (KPConv-FPN through csrc/kpconv.cu, the geometric transformer's
    cross blocks through csrc/attention.cu), its launches counted, stage
    times; pair 0 card against CPU stage by stage; LGR on a known pose at the
    full shapes; the lite transformer; both kernels at the zoo's shapes
    against their plain versions; (b-d) the other families, the encoders and
    the small functions card against CPU. Returns (the KPConv and attention
    kernels' zoo entries, launches {kpconv, masked_attention}, record)."""
    import torch

    from diffreg_tpu_torch.data.pyramid import PyramidConfig
    from diffreg_tpu_torch.nn.point_backbone import KPConvBias
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    t_phase = time.perf_counter()
    record = {}
    counts = zoo_level_counts(batch_cpu, PyramidConfig(first_subsampling_dl=0.03,
                                                       coarse_match_radius=0.1))
    cpu_models, card_models = zoo_models()
    fpn, gt, lite = card_models
    batch = batch_cpu.to("cuda")
    torch.cuda.reset_peak_memory_stats()
    zoo_drive(card_models, batch, counts)                       # warm-up
    kpconv_cuda.launches = 0
    masked_attention_cuda.launches = 0
    times, out = zoo_drive(card_models, batch, counts)
    n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
    if n_kp != 11 or n_at != 2 * ZOO_BLOCKS.count("cross"):
        raise AssertionError(f"zoo: {n_kp} KPConv launches (want 11), {n_at} attention "
                             f"launches (want {2 * ZOO_BLOCKS.count('cross')})")
    s3, t3, sm3, tm3, sf3, tf3 = out["nodes"]
    for name, t in (("source", out["src_c"]), ("target", out["tgt_c"])):
        want = (BATCH_PAIRS, s3.shape[1], ZOO_GT["output_dim"])
        if not bool(torch.isfinite(t).all()) or t.shape != want:
            raise AssertionError(f"zoo: {name} superpoint features {tuple(t.shape)} not finite")
    kept = [int(r[2].sum()) for r in out["lgr"]]
    for r, t, *_ in out["lgr"]:
        if not (bool(torch.isfinite(r).all()) and bool(torch.isfinite(t).all())):
            raise AssertionError("zoo: a non-finite LGR pose")
    record["stage_seconds"] = times
    record["lgr_correspondences"] = kept
    record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"zoo GeoTransformer drive, {BATCH_PAIRS} pairs (levels "
        f"{'/'.join(str(p.shape[1]) for p in batch.points)}, {s3.shape[1]} superpoint slots a "
        f"side): " + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
        + f" = {sum(times.values()):.4f} s; launches kpconv {n_kp} attention {n_at}; LGR "
        f"correspondences {kept}; peak memory {record['peak_memory_gib']:.2f} GiB")
    # the lite transformer once, its cross blocks through the kernel too
    masked_attention_cuda.launches = 0
    with torch.inference_mode():
        lite_out, lite_s = wall(lambda: lite(s3, t3, sf3, tf3, sm3, tm3))
    n_lite = masked_attention_cuda.launches
    if n_lite != 2 * ZOO_BLOCKS.count("cross") or not bool(torch.isfinite(lite_out[0]).all()):
        raise AssertionError(f"zoo lite transformer: {n_lite} attention launches")
    record["lite_seconds"] = lite_s
    log(f"zoo lite transformer: {lite_s:.4f} s, {n_lite} attention launches")
    problems = []
    cpu = zoo_pair0(card_models, cpu_models, batch_cpu, counts, record, problems)
    with collected(problems, "known pose"):
        zoo_known_pose(cpu, record)
    # both kernels at the zoo's shapes against their plain versions
    kp_entry, _ = check_kpconv(kpconv_layer_calls(fpn, lambda: fpn(zoo_pyramid(batch)),
                                                  KPConvBias),
                               11, "one KPConvFPN forward (11 calls)", tag=" (zoo)")
    log(f"kpconv (zoo): {kp_entry['ms']:.4f} ms a KPConvFPN forward (plain "
        f"{kp_entry['plain_ms']:.4f} ms, bound {kp_entry['bound_ms']:.4f} ms, "
        f"{kp_entry['bound_by']})")
    at_entry = zoo_attention_kernel(sm3, tm3, gen)
    log(f"attention (zoo): {at_entry['ms']:.4f} ms a GeometricTransformer forward (plain "
        f"{at_entry['plain_ms']:.4f} ms, SDPA {at_entry['library_ms']:.4f} ms, bound "
        f"{at_entry['bound_ms']:.4f} ms, {at_entry['bound_by']})")
    del out, cpu, batch
    zoo_families(record, gen, problems)
    record["seconds"] = time.perf_counter() - t_phase
    log(f"zoo phase: {record['seconds']:.1f} s on {card}")
    log(f"zoo: {json.dumps(record)}")
    if record["seconds"] > ZOO_PHASE_S:
        problems.append(f"the phase took {record['seconds']:.1f} s (limit {ZOO_PHASE_S})")
    if problems:
        raise AssertionError("zoo: " + "; ".join(problems))
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "per",
            "shapes")
    return ({k: kp_entry[k] for k in keep}, {k: at_entry[k] for k in keep}
            | {"relative_position_self": at_entry["relative_position_self"]},
            {"kpconv": n_kp, "masked_attention": n_at + n_lite}, record)


def library_inputs():
    """The phase's inputs when it runs alone (``--library``): the 3DMatch
    phase's batch, phase 9's pair 0, the 2D-3D phase's batch and spec (a split
    written to a temporary directory), and pair 0's correspondences taken from
    its coarse ground truth with a third of them replaced by random pairs (no
    DDIM runs here)."""
    import tempfile

    import numpy as np
    import torch

    from diffreg_tpu_torch.data.synthetic import make_pair

    _, batch_cpu = path_data()
    src, _, _, _, flow = make_pair(np.random.RandomState(1), N_POINTS, deformable=True,
                                   flow_amp=FLOW_AMP_4D, scale=SCALE_4D)
    with tempfile.TemporaryDirectory() as root:
        write_2d3d_split(root)
        batch2d3d, spec2d3d, _, _ = data_2d3d(root)
    return batch_cpu, synthetic_correspondences(batch_cpu), (src, flow), batch2d3d, spec2d3d


def synthetic_correspondences(batch_cpu):
    """Pair 0's coarse ground-truth matches (source and target points), a third
    of the targets shuffled into outliers."""
    import torch

    ok = batch_cpu.gt_valid[0]
    coarse = batch_cpu.points[-2][0]
    s = coarse[batch_cpu.src_idx_coarse[0][batch_cpu.gt_src[0][ok].long()].long()]
    t = coarse[batch_cpu.tgt_idx_coarse[0][batch_cpu.gt_tgt[0][ok].long()].long()]
    n_out = s.shape[0] // 3
    t[:n_out] = t[torch.randperm(s.shape[0], generator=torch.Generator().manual_seed(4))[:n_out]]
    return s, t


def phase4_correspondences(out):
    """Pair 0's correspondences of a ``register`` output (the points that
    ``correspond_and_ransac`` hands RANSAC), on the CPU."""
    from diffreg_tpu_torch.ops.select import extract_correspondences

    s_pcd, t_pcd = out["s_pcd"][:1], out["t_pcd"][:1]
    corrs = extract_correspondences(out["corr_mask"][:1], out["conf_matrix_pred"][:1],
                                    s_pcd.shape[1] + t_pcd.shape[1])
    ok = corrs.valid[0]
    return (s_pcd[0][corrs.src_idx[0][ok].long()].cpu(),
            t_pcd[0][corrs.tgt_idx[0][ok].long()].cpu())


def path_data():
    """(spec, CPU batch) of the 3DMatch phases: BATCH_PAIRS synthetic pairs of
    N_POINTS at the spec calibrated from two such pairs (K capped at 40)."""
    import numpy as np

    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.data.pyramid import PyramidConfig
    from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch

    pcfg = PyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
    cal_rng = np.random.RandomState(0)
    spec = calibrate_spec([make_pair(cal_rng, N_POINTS)[:2] for _ in range(2)], pcfg,
                          k_cap=40, neighbor_percentile=90.0)
    batch_cpu, _, _ = synthetic_batch(batch_size=BATCH_PAIRS, n_points=N_POINTS, seed=0,
                                      spec=spec, cfg=pcfg)
    return spec, batch_cpu


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError:
        print("chip_smoke: numpy and torch are needed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from diffreg_tpu_torch.eval.register import correspond_and_ransac, register
        from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
        from diffreg_tpu_torch.engine.losses import LossConfig
        from diffreg_tpu_torch.models.presets import (preset_3dmatch, preset_4dmatch,
                                                      with_condition_gate, with_fast_path)
        from diffreg_tpu_torch.nn.kpfcn import KPConv
        from diffreg_tpu_torch.ops.attention import masked_attention_cuda
        from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
        from diffreg_tpu_torch.utils.cuda import build_kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from a checkout",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if sys.argv[1:] == ["--library"]:                    # phase 24 alone
        run_library(card, *library_inputs())
        log(card)
        return 0
    if sys.argv[1:] == ["--zoo"]:                        # phase 25 alone (it builds the kernels)
        t0 = time.perf_counter()
        build_kernels()
        log(f"kernel build: {time.perf_counter() - t0:.2f} s")
        run_zoo(card, path_data()[1], torch.Generator().manual_seed(0))
        log(card)
        return 0

    # ---- 2. build ----
    t0 = time.perf_counter()
    report = build_kernels()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v['seconds']:.2f} s' for k, v in report.items())})")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "Function properties" in line or "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- data and model ----
    t0 = time.perf_counter()
    spec, batch_cpu = path_data()
    log(f"spec {spec}; host data {time.perf_counter() - t0:.2f} s")
    batch = batch_cpu.to("cuda")
    one = batch_cpu.select(slice(0, 1))
    cfg = preset_3dmatch(sample_steps=STEPS)
    models = {gate: DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cuda", seed=0)
              for gate in GATES}
    cpu_models = {gate: DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cpu",
                                               seed=0) for gate in GATES}
    gen = torch.Generator().manual_seed(0)
    x_init = torch.randn(BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
    u = torch.rand(BATCH_PAIRS, HYPOTHESES, 3, generator=gen)

    # ---- 3. kernels against their plain versions, forward and gradients ----
    kpconv_entry, kp_shapes = check_kpconv(
        kpconv_layer_calls(models[0.0], lambda: models[0.0].encode(batch), KPConv), 11,
        "one encode (11 calls)")
    kernels = [kpconv_entry, check_attention(batch, cfg, gen)]
    check_gradients(kernels, kp_shapes, batch, cfg, gen)
    del kp_shapes

    # ---- 3c. the 4DMatch shapes: KPConv per layer, attention at D = 132 ----
    t0 = time.perf_counter()
    batch4_cpu, meta4, spec4, pairs4 = deformable_data()
    log(f"4DMatch spec {spec4}; host data {time.perf_counter() - t0:.2f} s")
    batch4 = batch4_cpu.to("cuda")
    cfg4 = preset_4dmatch(sample_steps=STEPS)
    model4 = DiffusionMatchingModel(cfg4, device="cuda", seed=0)
    kp4, kp4_shapes = check_kpconv(kpconv_layer_calls(model4, lambda: model4.encode(batch4),
                                                      KPConv), 11, "one encode (11 calls)",
                                   tag=" (4DMatch)")
    del kp4_shapes, model4
    kernels[0]["shapes_4dmatch"] = kp4["shapes"]
    at4 = check_attention(batch4, cfg4, gen, tag=" (4DMatch)")
    grad4, back4 = attention_gradients(batch4, cfg4, gen)
    kernels[1]["d132"] = {k: at4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "per")}
    kernels[1]["d132"].update({"backward_ms": back4, "backward_max_rel_err": grad4})
    kernels[1]["shapes"] += at4["shapes"]
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], at4["max_abs_err"])
    del batch4

    # ---- 4. the DDIM path ----
    torch.cuda.reset_peak_memory_stats()      # the gradient checks above are not its peak
    results = {}
    launches = {"kpconv": 0, "masked_attention": 0, "masked_attention_d132": 0,
                "kpconv_any_p": 0, "kpconv_bf16_any_p": 0, "masked_attention_any_d": 0,
                "masked_attention_bf16_any_d": 0,
                **{f"{route}_{kind}": 0 for route in ("masked_attention_any_d",
                                                       "masked_attention_bf16_any_d")
                   for kind in ("tensor_cores", "cuda_cores")},
                **{f"{kind}_{route}": 0 for kind in ("kpconv", "kpconv_bf16")
                   for route in ("any_p_tensor_cores", "any_shape_tensor_cores")},
                "kpconv_any_shape": 0, "kpconv_bf16_any_shape": 0, "kpconv_2d3d": 0,
                "masked_attention_d64": 0, "masked_attention_d64_dino": 0, "kpconv_train_2d3d": 0,
                "masked_attention_train_2d3d": 0, "kpconv_bf16": 0,
                "masked_attention_bf16": 0, "masked_attention_bf16_d144": 0,
                "kpconv_bf16_story": 0, "masked_attention_bf16_story": 0,
                "kpconv_story_2d3d": 0, "masked_attention_story_2d3d": 0,
                "kpconv_bf16_story4d": 0, "masked_attention_bf16_story4d": 0,
                "kpconv_dp": 0, "masked_attention_dp": 0}
    f32_ref = {}
    per_step = attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    for gate, model in models.items():
        register(model, batch, x_init, u)                      # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            kpconv_cuda.route_launches = {}
            masked_attention_cuda.launches = 0
            out, seconds = wall(lambda: register(model, batch, x_init, u))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            routes = dict(kpconv_cuda.route_launches)
            if n_kp != 11 or n_at != per_step * STEPS or routes != ENCODE_ROUTES:
                raise AssertionError(f"gate {gate}: {n_kp} KPConv launches (want 11) by route "
                                     f"{routes} (want {ENCODE_ROUTES}), {n_at} attention "
                                     f"launches (want {per_step * STEPS})")
            launches["kpconv"] += n_kp
            launches["kpconv_any_shape"] += routes["any_shape_tensor_cores"]
            launches["masked_attention"] += n_at
            times.append(seconds)
        seconds = sorted(times)[TIMED_RUNS // 2]
        check_outputs(out, f"gate {gate}")
        f32_ref[gate] = {"pairs_per_s": BATCH_PAIRS / seconds,
                         **{k: out[k][:1] for k in ("conf_matrix_pred", "rotation_pred",
                                                    "translation_pred")}}
        with torch.inference_mode():
            _, enc_s = wall(lambda: model.encode(batch))
            ddim_out, ddim_s = wall(lambda: model.ddim_sample(batch, x_init.cuda()))
            _, ransac_s = wall(lambda: correspond_and_ransac(ddim_out, u.cuda()))
        results[gate] = out
        cond = out.get("step_condition")
        accepted = "" if cond is None else \
            f", warps accepted {int((cond < gate).sum())}/{cond.numel()}"
        log(f"main path gate {gate}: {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = "
            f"{BATCH_PAIRS / seconds:.3f} pairs/s; encode {enc_s:.4f} s, DDIM "
            f"{ddim_s - enc_s:.4f} s, correspondences + RANSAC {ransac_s:.4f} s; "
            f"launches kpconv {n_kp} attention {n_at}{accepted}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 5. one pair of the DDIM path through the same port on the CPU ----
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    for gate in GATES:
        t0 = time.perf_counter()
        ref = register(cpu_models[gate], one, x_init[:1], u[:1], device="cpu")
        compare_pair(results[gate], ref, valid,
                     f"gate {gate} (CPU {time.perf_counter() - t0:.1f} s)")
        check_outputs(ref, f"CPU gate {gate}")

    # ---- RANSAC against the ground truth, on the card and on the CPU ----
    # With random weights the path's correspondences are noise, where ties
    # among near-equal hypotheses decide the pose; so RANSAC is held on pair
    # 0's coarse source points under its ground-truth pose, 40% outliers.
    check_ransac(results[0.0]["s_pcd"][0, :int(batch_cpu.src_mask[0].sum())],
                 batch_cpu.rot_gt[0], batch_cpu.trn_gt[0], u[:1], gen)
    corr0 = phase4_correspondences(results[0.0])          # phase 24's consistency input
    del results

    # ---- 6. backbone_forward ----
    run_backbone(models[0.0], batch, cpu_models[0.0], one, launches)
    del models, cpu_models

    # ---- 7. training at full width through the Trainer, then resume ----
    cfg_train = preset_3dmatch(train=True)
    f32_train = run_training(cfg_train, batch, launches)

    # ---- 8. one train step, card against CPU ----
    train_step_card_vs_cpu(cfg_train, one)

    # ---- 8b. the bf16 fast path: its kernels, the DDIM at gate 0 and 40, pair 0
    # on the CPU, main on configs/test/3dmatch_fast.yaml ----
    bf16_kernels, bf16_pairs = run_bf16(repo, batch, batch_cpu, spec, x_init, u, f32_ref,
                                        batch4_cpu, gen, launches)
    kernels += bf16_kernels
    for gate in GATES:
        kernels[3].setdefault("pairs_per_s", {})[str(gate)] = {
            "bf16": bf16_pairs[gate], "f32": f32_ref[gate]["pairs_per_s"]}
    del f32_ref

    # ---- 8c. bf16 training: the 3DMatch Trainer beside phase 7's f32 step,
    # pair 0 card vs CPU, the 4DMatch Trainer (instance 144), main --mode train
    # on bf16 copies of the train YAMLs, then 3dmatch_fast.yaml on the checkpoint ----
    kernels[3]["training"] = run_bf16_training(repo, batch, one, batch4_cpu, f32_train,
                                               launches)

    # ---- 8d. one 4DMatch train step of pair 0, card against CPU, f32 and bf16 ----
    cfg4_train = preset_4dmatch(sample_steps=STEPS)
    one4 = batch4_cpu.select(slice(0, 1))
    loss4 = LossConfig(**LOSS_4D)
    kernels[3]["training"]["pair0_4dmatch"] = {
        "f32": train_step_card_vs_cpu(cfg4_train, one4, tag=" 4DMatch", loss_cfg=loss4),
        "bf16": train_step_card_vs_cpu(with_fast_path(cfg4_train), one4, TRAIN_BF16_LIMITS_4D,
                                       f32_cfg=cfg4_train, tag=" 4DMatch bf16", loss_cfg=loss4)}

    # ---- 9-10. the 4DMatch path through FourDMatchTester; pair 0 on the CPU ----
    run_4dmatch(batch4_cpu, meta4, spec4, launches)

    # ---- 11. the entry point: 4DMatch test, 3DMatch test, 4DMatch train ----
    run_cli(repo, pairs4, meta4, launches)

    # ---- 12-17. 2D-3D: kernels at its shapes, the tester path, pair 0, the CLI,
    # training, the published model with its towers ----
    batch2d3d, spec2d3d = run_2d3d_phases(repo, kernels, launches, gen)

    # ---- 18. the synthetic training story: both bf16 kernels at its shapes,
    # then the committed trained weights: the test split and pair 0 card vs CPU ----
    tool = story_tool(repo)
    kernels[2]["story"], kernels[3]["story"] = run_story_kernels(tool, gen)
    kernels[3]["story"]["trained"] = run_story_trained(repo, tool, launches)

    # ---- 19. the 2D-3D synthetic training story: both f32 kernels at its
    # shapes, then the committed trained weights: the test split and pair 0's
    # DDIM output card vs CPU ----
    trained = run_story2d3d(repo, kernels, launches, gen)
    kernels[1]["story_2d3d"]["trained"] = trained

    # ---- 20. the 4DMatch synthetic training story: both bf16 kernels at its
    # shapes, then the committed trained weights: the test split and pair 0
    # card vs CPU at the protocol's threshold 0.55 ----
    kernels[2]["story_4d"], kernels[3]["story_4d"] = run_story4d(repo, kernels, launches, gen)

    # ---- 21. data parallel on the card: a one-process NCCL group bit for bit
    # against the plain step, two processes sharing the card against it ----
    kernels[0]["data_parallel"] = {
        "one_process": data_parallel_one_process(cfg_train, batch, launches),
        "two_processes": data_parallel_two_processes(cfg_train, batch_cpu, launches)}

    # ---- 22. the model variants: the KPConv mode instances against their plain
    # versions, variants A and B at full width card against CPU, main on a
    # variant YAML ----
    kernels += run_variants(repo, batch, batch_cpu, spec, x_init, u, launches, gen)

    # ---- 23. the shape range: both kernels at every kernel-point count and head
    # width in SHAPE_POINTS / SHAPE_HEAD_WIDTHS against their plain versions,
    # configurations C (24 kernel points, D 54) and W (D 216) at full width card
    # against CPU, main on C's YAML and on 4DMatch at D 528 ----
    kernels += run_shape_range(repo, batch, batch_cpu, spec, x_init, u, launches, gen)

    # ---- 24. the library surface: neighbours, FPS, point features, consistency,
    # deformation, EPro-PnP, render and pack at the system's data sizes, card
    # against CPU ----
    run_library(card, batch_cpu, corr0, (pairs4[0][0], pairs4[0][4]), batch2d3d, spec2d3d)

    # ---- 25. the model zoo: GeoTransformer's forward at its published width through
    # both kernels, pair 0 card against CPU, LGR on a known pose; the other zoo
    # families, the encoders and the small library functions card against CPU ----
    kp_zoo, at_zoo, zoo_launches, _ = run_zoo(card, batch_cpu, gen)
    kernels[0]["zoo"] = {**kp_zoo, "launches": zoo_launches["kpconv"]}
    kernels[1]["zoo"] = {**at_zoo, "launches": zoo_launches["masked_attention"]}
    launches["kpconv_zoo"] = zoo_launches["kpconv"]
    launches["masked_attention_zoo"] = zoo_launches["masked_attention"]

    kernels += any_shape_entries(kernels, launches)
    kernels[0]["launches"] = (launches["kpconv"] + launches["kpconv_train_2d3d"]
                              + launches["kpconv_story_2d3d"] + launches["kpconv_dp"]
                              + launches["kpconv_zoo"])
    kernels[0]["launches_zoo"] = launches["kpconv_zoo"]
    kernels[0]["launches_2d3d"] = launches["kpconv_2d3d"]
    kernels[1]["launches_zoo"] = launches["masked_attention_zoo"]
    kernels[0]["launches_data_parallel"] = launches["kpconv_dp"]
    kernels[1]["launches_data_parallel"] = launches["masked_attention_dp"]
    kernels[0]["launches_train_2d3d"] = launches["kpconv_train_2d3d"]
    kernels[0]["launches_story_2d3d"] = launches["kpconv_story_2d3d"]
    d64 = launches["masked_attention_d64"] + launches["masked_attention_train_2d3d"]
    kernels[1]["launches"] = (launches["masked_attention"] + launches["masked_attention_d132"]
                              + d64 + launches["masked_attention_d64_dino"]
                              + launches["masked_attention_story_2d3d"]
                              + launches["masked_attention_dp"]
                              + launches["masked_attention_zoo"])
    kernels[1]["launches_story_2d3d"] = launches["masked_attention_story_2d3d"]
    kernels[1]["launches_d132"] = launches["masked_attention_d132"]
    kernels[1]["launches_d64"] = d64
    kernels[1]["launches_d64_dino"] = launches["masked_attention_d64_dino"]
    kernels[1]["launches_train_2d3d"] = launches["masked_attention_train_2d3d"]
    kernels[2]["launches"] = (launches["kpconv_bf16"] + launches["kpconv_bf16_story"]
                              + launches["kpconv_bf16_story4d"])
    kernels[2]["launches_story"] = launches["kpconv_bf16_story"]
    kernels[2]["launches_story_4d"] = launches["kpconv_bf16_story4d"]
    kernels[3]["launches"] = (launches["masked_attention_bf16"]
                              + launches["masked_attention_bf16_d144"]
                              + launches["masked_attention_bf16_story"]
                              + launches["masked_attention_bf16_story4d"])
    kernels[3]["launches_d144"] = launches["masked_attention_bf16_d144"]
    kernels[3]["launches_story"] = launches["masked_attention_bf16_story"]
    kernels[3]["launches_story_4d"] = launches["masked_attention_bf16_story4d"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
